"""Training loop: data pipeline -> train step -> checkpoints.

Twin of ``repro/launch/train.py``, with its flags and result dict plus
``--device``.  Behaviours wired in:
  * resume-from-latest on start (fault-tolerant restart)
  * periodic async checkpoints draining through NMA C2H channels
  * ``StepGuard`` retries + restore-on-corruption; ``StragglerMonitor``
  * optional host-offloaded optimizer state (the paper-technique path)

The state starts from ``--seed`` (``T.tree_init``).  ``--device``
defaults to ``cuda``, which raises without a card; ``--device cpu``
runs on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-0.5b --smoke --steps 30 --device cpu

Each process loads its shard of the data: ``shard_id`` and
``num_shards`` are its rank and the world size of the process group
when one is initialised (the reference's ``jax.process_index()`` and
``process_count()``), else 0 of 1.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.core.engine import MemoryEngine
from repro_torch.core.offload import HostOffloadedOptimizer
from repro_torch.data.pipeline import (BatchSpec, DevicePrefetcher,
                                       PackedBatcher, SyntheticCorpus)
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import StepGuard, StragglerMonitor


def data_shard() -> dict:
    """This process's ``shard_id`` and ``num_shards`` (module note)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return {"shard_id": dist.get_rank(),
                "num_shards": dist.get_world_size()}
    return {"shard_id": 0, "num_shards": 1}


def build_state(cfg, opt, seed: int = 0, device="cuda"):
    params = T.tree_init(T.param_defs(cfg), cfg, seed, device)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--offload-optimizer", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises without "
                         "a card; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_initialized():
        # a full-width optimizer step allocates multi-GB float32
        # temporaries after the backward frees its blocks: let the
        # allocator grow segments rather than split cached ones
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    opt = AdamW(lr=args.lr, warmup_steps=max(5, args.steps // 10),
                decay_steps=max(10, args.steps))

    corpus = SyntheticCorpus(cfg.vocab, seed=args.seed)
    batcher = PackedBatcher(corpus, BatchSpec(args.batch, args.seq),
                            **data_shard())
    prefetch = DevicePrefetcher(batcher, depth=2, n_channels=2,
                                device=device)

    state = build_state(cfg, opt, args.seed, device)
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2, device=device)
        latest = ckpt.latest_step()
        if latest is not None:
            _, state = ckpt.restore(state)
            print(f"[train] resumed from step {latest}", flush=True)

    offload = None
    if args.offload_optimizer:
        offload = HostOffloadedOptimizer(
            opt, state["params"],
            engine=MemoryEngine(n_channels=4, device=device))
    step_fn = lm.make_train_step(cfg, opt)

    def restore():
        assert ckpt is not None
        _, s = ckpt.restore(state)
        return s

    guard = StepGuard(max_retries=1, on_restore=restore if ckpt else None)
    monitor = StragglerMonitor()

    losses = []
    t_start = time.time()
    try:
        for i in range(args.steps):
            batch = next(prefetch)
            t0 = time.time()
            if offload is not None:
                (loss, _), grads = lm.value_and_grad(cfg, state["params"],
                                                     batch)
                new_params = offload.step(state["params"], grads,
                                          state["step"])
                del grads
                state = {"params": new_params, "opt": state["opt"],
                         "step": state["step"] + 1}
                metrics = {"loss": loss}
            else:
                state, metrics = guard.run(step_fn, state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.record(i, time.time() - t0)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"[train] step {i:5d} loss {loss:.4f} "
                      f"({time.time()-t0:.2f}s/step)", flush=True)
            if ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
                ckpt.save(int(state["step"]), state, block=False)
        if ckpt:
            ckpt.save(int(state["step"]), state, block=True)
    finally:
        prefetch.close()
        if ckpt:
            ckpt.close()
        if offload is not None:
            offload.close()
    dt = time.time() - t_start
    result = {"final_loss": losses[-1], "first_loss": losses[0],
              "losses": losses, "seconds": dt,
              "stragglers": monitor.stragglers,
              "failures": guard.failures}
    print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {dt:.1f}s ({args.steps} steps)", flush=True)
    return result


if __name__ == "__main__":
    main()
