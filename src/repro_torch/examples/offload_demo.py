"""NMA engine demo: the paper's technique as framework features.

Twin of ``examples/offload_demo.py``:

1. multi-channel host<->device bandwidth sweep (XDMA model, Figs 9/10),
   each row beside the paper's PCIe/DDR4 model;
2. host-offloaded AdamW (the moments stream through the engine every
   step);
3. tiered KV store: cache pages moving between hot device slots and the
   access path the model-driven selector picks per request.

Host wall times of one run each; ``--device cpu`` moves host copies.

    python -m repro_torch.examples.offload_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (ChannelPool, Direction, HostOffloadedOptimizer,
                              MemoryEngine, TieredStore)
from repro_torch.core.analytical import bandwidth_gbps, paper_pcie_ddr4
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamW


def bw_sweep(dev) -> list:
    print("== multi-channel H2C/C2H sweep (paper Figs 9/10) ==")
    model = paper_pcie_ddr4()
    rows = []
    for nch in (1, 4):
        with ChannelPool(nch, chunk_bytes=1 << 20, device=dev) as pool:
            for size_mb in (1, 8):
                x = np.ones(size_mb << 18, np.float32)  # size_mb MB
                t0 = time.perf_counter()
                out = pool.h2c(x).wait()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t = time.perf_counter() - t0
                if not bool(torch.all(out == 1)):
                    raise AssertionError("H2C bytes differ")
                anchor = bandwidth_gbps(model, x.nbytes, nch, Direction.H2C)
                print(f"  {nch}ch {size_mb:2d}MB H2C: {x.nbytes/t/1e9:6.2f} "
                      f"GB/s (paper-model {anchor:5.1f} GB/s)")
                rows.append({"channels": nch, "mb": size_mb,
                             "gbps": x.nbytes / t / 1e9})
    return rows


def offload_optimizer(dev) -> dict:
    print("== host-offloaded AdamW ==")
    params = {f"layer{i}": torch.ones((256, 256), device=dev)
              for i in range(8)}
    grads = {k: 0.01 * torch.ones_like(p) for k, p in params.items()}
    opt = AdamW(lr=1e-3)
    ho = HostOffloadedOptimizer(opt, params,
                                engine=MemoryEngine(n_channels=4,
                                                    device=dev))
    try:
        t0 = time.perf_counter()
        new_params = ho.step(params, grads,
                             torch.zeros((), dtype=torch.int32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        stats = ho.engine.stats()
        print(f"  step with streamed moments: {dt*1e3:.1f} ms, "
              f"host-resident state {ho.host_bytes()>>20} MB, "
              f"channel stats {stats}")
    finally:
        ho.close()
    return {"seconds": dt, "host_bytes": ho.host_bytes(),
            "params": new_params}


def kv_paging(dev) -> dict:
    print("== tiered KV store over the auto access path ==")
    pager = TieredStore(n_pages=64, page_shape=(2, 512, 2, 64),
                        dtype="float16", n_hot_slots=8, path="auto",
                        device=dev)
    try:
        rng = np.random.default_rng(0)
        for p in range(64):
            pager.write_page(p, rng.standard_normal((2, 512, 2, 64)))
        t0 = time.perf_counter()
        for window in range(0, 56, 8):      # sliding attention window walk
            pager.ensure(list(range(window, window + 8)))
        dt = time.perf_counter() - t0
        placement = pager.stats()["cold"].get("placement", {})
        print(f"  paged {pager.h2c_bytes>>20} MB H2C / "
              f"{pager.c2h_bytes>>20} MB C2H in {dt*1e3:.0f} ms "
              f"(page={pager.page_bytes>>10} KB, placement={placement})")
        return {"seconds": dt, "h2c_bytes": pager.h2c_bytes,
                "placement": placement}
    finally:
        pager.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    return {"bw": bw_sweep(dev), "offload": offload_optimizer(dev),
            "kv": kv_paging(dev)}


if __name__ == "__main__":
    main()
