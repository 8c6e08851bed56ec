"""Paper Figs 9, 10, 15-18: host<->device bandwidth against transfer size
and channel count, on the card.

Twin of ``benchmarks/host_device_bw.py``.  Moves seeded int32 arrays of
64 KB to 16 MB (256 KB to 4 MB with ``--quick``) through a
``ChannelPool`` of 1, 2 and 4 channels (1 MiB chunks), H2C and C2H.
Each call waits on the host, so each row holds host wall time (median of
3).  Per row, ``fig9_10_bw_{dir}_ch{n}_{KB}KB``:

* ``meas``: bytes over that time;
* ``proj_alveo``: ``project`` of ``meas`` onto the paper's Alveo DDR4
  path, against the card's ceiling (``pinned_h2d_gbps``: one pinned
  64 MiB host->device copy);
* ``h100_model``: the ``h100_host_path`` model at that size, channel
  count and direction, in the place of the reference's ``proj_tpu``.

Each H2C chunk is copied into a pinned staging buffer on the host before
its device copy (``core/channels.py``), and C2H lands straight in a
pinned buffer: the H2C rows carry that host copy, C2H rows do not.  The
C2H result is checked byte for byte against the host array once per
(channels, size).  With ``--device cpu`` the pool moves host copies and
``proj_alveo`` is not measured (there is no card to set the ceiling).

    python -m repro_torch.benchmarks.host_device_bw [--quick]
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.benchmarks.common import (bench_seed, emit,
                                           pinned_h2d_gbps, time_call)
from repro_torch.core.analytical import (bandwidth_gbps, h100_host_path,
                                         paper_pcie_ddr4, project)
from repro_torch.core.channels import ChannelPool, Direction
from repro_torch.device import resolve_device

SIZES = [1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24]   # 64KB..16MB
CHANNELS = [1, 2, 4]


def run(quick: bool = False, device=None) -> List[dict]:
    dev = resolve_device(device)
    sizes = SIZES[1:4] if quick else SIZES
    ceiling = pinned_h2d_gbps() if dev.type == "cuda" else None
    if ceiling is not None:
        print(f"# ceiling: pinned host->device 64 MiB {ceiling:.3f} GB/s",
              flush=True)
    model = paper_pcie_ddr4()
    card = h100_host_path()
    out = []
    for nch in CHANNELS:
        with ChannelPool(nch, device=dev, chunk_bytes=1 << 20) as pool:
            for size in sizes:
                rows = size // 256
                host = np.random.default_rng(bench_seed()).integers(
                    0, 255, size=(rows, 64), dtype=np.int32)
                dev_t = pool.h2c(host).wait()
                if not np.array_equal(pool.c2h(dev_t).wait(), host):
                    raise AssertionError(
                        f"ch{nch} {size}B: round trip bytes differ")
                calls = {Direction.H2C: lambda: pool.h2c(host).wait(),
                         Direction.C2H: lambda: pool.c2h(dev_t).wait()}
                for direction, fn in calls.items():
                    t = time_call(fn, repeats=3)
                    meas = size / t / 1e9
                    h100 = bandwidth_gbps(card, size, nch, direction)
                    row = {"direction": direction.value, "channels": nch,
                           "size_bytes": size, "us": t * 1e6,
                           "meas_gbps": meas, "h100_model_gbps": h100}
                    if ceiling is None:
                        alveo = "not_measured"
                    else:
                        row["proj_alveo_gbps"] = project(
                            meas, ceiling, model, size, nch, direction)
                        alveo = f"{row['proj_alveo_gbps']:.1f}"
                    emit(f"fig9_10_bw_{direction.value}_ch{nch}_"
                         f"{size >> 10}KB",
                         t * 1e6,
                         f"meas={meas:.2f}GB/s proj_alveo={alveo} "
                         f"h100_model={h100:.1f}")
                    out.append(row)
    return out


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
