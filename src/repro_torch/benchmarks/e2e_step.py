"""End-to-end step benches: the train step of the reduced configs, and
the roofline summary read from dry-run artifacts.

Twin of ``benchmarks/e2e_step.py``, with its row names plus
``--device``.  Each row is host wall time (median of 3) around one train
step that ends in a device synchronise, so it holds the card's work.
The roofline rows read ``experiments/dryrun_torch/single/*.json``, the
artifacts of the port's dry run (``python -m repro_torch.launch.dryrun``,
H100 constants); without that folder there are none, as in the
reference.

    python -m repro_torch.benchmarks.e2e_step [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import List

import numpy as np
import torch

from repro_torch.benchmarks.common import bench_seed, emit, time_call
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import ART_DIR
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(quick: bool = False, device=None) -> List[dict]:
    dev = resolve_device(device)
    archs = ["qwen2-0.5b"] if quick else ["qwen2-0.5b", "rwkv6-1.6b",
                                          "recurrentgemma-2b"]
    rows = []
    for arch in archs:
        cfg = reduce_for_smoke(get_config(arch))
        params = T.tree_init(T.param_defs(cfg), cfg, bench_seed(), dev)
        opt = AdamW(lr=1e-3)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        rng = np.random.default_rng(bench_seed())
        B, S = 2, 64
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
            for k in ("tokens", "labels")}
        step = lm.make_train_step(cfg, opt)

        def one():
            nonlocal state
            state, _ = step(state, batch)
            _sync(dev)
        t = time_call(one, repeats=3)
        toks = B * S
        emit(f"e2e_train_step_{arch}", t * 1e6,
             f"{toks/t:.0f} tok/s (smoke cfg)")
        rows.append({"name": f"e2e_train_step_{arch}", "seconds": t,
                     "tok_per_s": toks / t})

    # roofline summary from artifacts (if the dry-run has been run)
    for path in sorted(glob(os.path.join(ART_DIR, "single", "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "roofline" not in rec:
            continue
        r = rec["roofline"]
        emit(f"roofline_{rec['arch']}_{rec['shape']}",
             max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e6,
             f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}")
        rows.append({"name": f"roofline_{rec['arch']}_{rec['shape']}",
                     "roofline": r})
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
