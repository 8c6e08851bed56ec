"""Paper Table 1 (offloaded workloads): optimizer-offload step overhead.

Twin of ``benchmarks/offload_step.py``, with its row names plus
``--device``.  Times a reduced qwen2-0.5b train step with (a) the
device-resident AdamW and (b) the NMA host-offloaded optimizer (moments
streamed through the engine, leaf-pipelined), and a tiered-store
``ensure()`` of 4 pages: the two production offload paths.  Every row
waits on the host (a synchronise, a DMA, a store op), so each is host
wall time (median of 3, the page round of 5).  The store's pages are
float16 where the reference's are bfloat16 (numpy, which types the
port's pages, has no bfloat16): the same 16 KB page.

    python -m repro_torch.benchmarks.offload_step [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import bench_seed, emit, time_call
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.offload import HostOffloadedOptimizer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.rmem.store import TieredStore


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(quick: bool = False, device=None) -> Dict[str, float]:
    dev = resolve_device(device)
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    params = T.tree_init(T.param_defs(cfg), cfg, bench_seed(), dev)
    opt = AdamW(lr=1e-3)
    B, S = 2, 64
    rng = np.random.default_rng(bench_seed())
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}

    step = lm.make_train_step(cfg, opt)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def dev_step():
        nonlocal state
        state, _ = step(state, batch)
        _sync(dev)
    t_dev = time_call(dev_step, repeats=3)
    emit("tab1_step_device_optimizer", t_dev * 1e6, "")

    ho = HostOffloadedOptimizer(opt, params, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def off_step():
        _, grads = lm.value_and_grad(cfg, params, batch)
        ho.step(params, grads, zero)
        _sync(dev)
    try:
        t_off = time_call(off_step, repeats=3)
        emit("tab1_step_offloaded_optimizer", t_off * 1e6,
             f"overhead_vs_device={(t_off/t_dev-1)*100:.0f}% "
             f"host_bytes={ho.host_bytes()>>20}MB")
    finally:
        ho.close()

    pager = TieredStore(n_pages=32, page_shape=(64, 128), n_hot_slots=8,
                        path="xdma", dtype="float16", device=dev)
    try:
        for p in range(32):
            pager.write_page(p, np.zeros((64, 128), np.float32))
        rr = [0]

        def page_round():
            base = rr[0] % 24
            pager.ensure([base, base + 1, base + 2, base + 3])
            rr[0] += 4
        t_pg = time_call(page_round, repeats=5)
        emit("tab1_kv_pager_ensure4", t_pg * 1e6,
             f"page={pager.page_bytes>>10}KB h2c={pager.h2c_bytes>>20}MB")
    finally:
        pager.close()
    return {"device_step_s": t_dev, "offloaded_step_s": t_off,
            "host_bytes": ho.host_bytes(), "pager_ensure4_s": t_pg}


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    return run(quick=args.quick, device=args.device)


if __name__ == "__main__":
    main()
