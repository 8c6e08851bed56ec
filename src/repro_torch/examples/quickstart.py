"""Quickstart: train a small qwen2-family LM end to end.

Twin of ``examples/quickstart.py``: config -> params -> data pipeline ->
train step -> async checkpoint -> restore, 40 steps of the reduced
qwen2-0.5b (``reduce_for_smoke``), weights from seed 0.  The checkpoint
lands in a temporary directory, deleted afterwards; the restore is held
to the saved step.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.pipeline import (BatchSpec, DevicePrefetcher,
                                       PackedBatcher, SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    print(f"model: {cfg.arch_id} (reduced) "
          f"~{cfg.n_params/1e6:.1f}M params analytical")

    opt = AdamW(lr=5e-3, warmup_steps=5, decay_steps=60)
    params = T.tree_init(T.param_defs(cfg), cfg, 0, dev)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    batcher = PackedBatcher(corpus, BatchSpec(batch=4, seq_len=64))
    prefetch = DevicePrefetcher(batcher, depth=2, device=dev)

    step = lm.make_train_step(cfg, opt)
    losses = []
    try:
        with tempfile.TemporaryDirectory() as d:
            ckpt = CheckpointManager(d, keep=2, device=dev)
            try:
                for i in range(args.steps):
                    state, metrics = step(state, next(prefetch))
                    losses.append(float(metrics["loss"]))
                    if i % 10 == 0:
                        print(f"step {i:3d}  loss {losses[-1]:.4f}")
                    if (i + 1) % 20 == 0:
                        ckpt.save(int(state["step"]), state, block=False)
                ckpt.wait()
                restored_step, _ = ckpt.restore(state)
            finally:
                ckpt.close()
            print(f"checkpoint roundtrip ok (restored step "
                  f"{restored_step})")
    finally:
        prefetch.close()
    print(f"final loss {losses[-1]:.4f}")
    return {"losses": losses, "restored_step": restored_step}


if __name__ == "__main__":
    main()
