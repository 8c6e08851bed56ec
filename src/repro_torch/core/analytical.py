"""Analytical bandwidth model of the host<->accelerator path.

Twin of ``repro/core/analytical.py``, fitted to the paper's measured
curves (Figs 8-18).  The model:

    bw(size, ch, path) = link_peak(path)
                         * chan_eff(ch)          # multi-channel aggregation
                         * amort(size, ch)       # setup-latency amortisation
                         * dir_eff(direction)    # H2C/C2H asymmetry

* ``amort``: each channel moves size/ch bytes; a transfer costs a fixed
  per-descriptor setup ``t0`` plus bytes/bw, so small transfers underuse
  the link — the rising flank of every figure in the paper.
* ``chan_eff``: one engine sustains ~70% of the link; channels aggregate
  with diminishing returns (arbitration), cap at ~88%.
* ``dir_eff``: C2H outperforms H2C (posted writes vs non-posted reads).
* contention with a second master multiplies by ``contention_factor``.

The port's host path is ``h100_host_path``, and ``qdma_host_path`` is
the same link behind descriptor queues; ``h100_d2d_path`` is the copy
between two allocations in the card's memory, the one device<->device
transfer a one-card machine has (the stand-in for the reference's
chip<->chip ``tpu_ici_path``); ``far_memory_path`` is the reference's
100 Gb/s RNIC model of NIC-attached memory, which is no TPU figure and
keeps its constants; the paper's own FPGA paths stay for reference.
``project`` carries a measurement's fraction of its ceiling onto
another path.  No TPU part is modelled here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.channels import Direction

# Pinned host->device copy rate (``benchmarks/common.py::
# pinned_h2d_gbps``: one 64 MiB copy, median of 10), as ``chip_smoke.py``
# printed it on an NVIDIA H100 80GB HBM3 (power limit 700.00 W).  The
# link ceiling of ``h100_host_path``.
H100_PINNED_H2D_GBPS = 51.954

# Device-to-device copy on the same card (``benchmarks/common.py``:
# ``d2d_copy_gbps``, one 256 MiB ``copy_`` between two allocations, CUDA
# events, median of 10; ``d2d_copy_latency_us``, host wall time of one
# 4 KiB ``copy_`` and a synchronize, median of 50), measured on an
# NVIDIA H100 80GB HBM3 (power limit 700.00 W).  The ceiling and the
# per-op setup of ``h100_d2d_path``.
H100_D2D_COPY_GBPS = 1453.202
H100_D2D_T0_US = 11.945


@dataclass(frozen=True)
class PathModel:
    link_gbps: float          # physical ceiling of the narrowest segment
    t0_us: float = 10.0       # per-descriptor setup/doorbell cost
    single_eff: float = 0.70  # one engine's fraction of the link
    max_eff: float = 0.88     # aggregated ceiling
    c2h_boost: float = 1.10   # direction asymmetry
    contention_factor: float = 0.88


def chan_eff(m: PathModel, channels: int) -> float:
    eff = m.single_eff + (m.max_eff - m.single_eff) * (1 - 0.5 ** (channels - 1))
    return min(eff, m.max_eff)


def bandwidth_gbps(m: PathModel, size_bytes: int, channels: int = 1,
                   direction: Direction = Direction.C2H,
                   contended: bool = False) -> float:
    peak = m.link_gbps * chan_eff(m, channels)
    if direction == Direction.C2H:
        peak = min(peak * m.c2h_boost, m.link_gbps * 0.92)
    per_ch = size_bytes / max(channels, 1)
    t_setup = m.t0_us * 1e-6
    t_move = per_ch / (peak * 1e9)
    bw = size_bytes / ((t_setup + t_move) * 1e9)
    if contended:
        bw *= m.contention_factor
    return min(bw, peak)


# Pre-built paths -----------------------------------------------------------

def paper_pcie_ddr4() -> PathModel:
    """Alveo U250 DDR4-over-XDMA path (Figs 9/10)."""
    return PathModel(link_gbps=15.8)


def paper_pcie_bram() -> PathModel:
    """Alveo U250 BRAM path (Fig 8): narrow AXI path bounds it lower."""
    return PathModel(link_gbps=15.8, single_eff=0.50, max_eff=0.55,
                     c2h_boost=1.03, t0_us=10.0)


def h100_host_path() -> PathModel:
    """Host DRAM <-> H100 device memory over PCIe, with the pinned H2D
    rate measured on the card as its link ceiling."""
    return PathModel(link_gbps=H100_PINNED_H2D_GBPS)


def h100_d2d_path() -> PathModel:
    """Device memory -> device memory on the same H100: one copy between
    two allocations, the stand-in for the reference's chip<->chip ICI
    path (``rdma_analogue``'s model column).  One copy engine moves the
    whole measured rate, so there is no multi-channel gain and no
    direction asymmetry; the per-op setup is a small copy's launch and
    synchronize."""
    return PathModel(link_gbps=H100_D2D_COPY_GBPS, t0_us=H100_D2D_T0_US,
                     single_eff=1.0, max_eff=1.0, c2h_boost=1.0)


def qdma_host_path() -> PathModel:
    """Host DRAM <-> device memory through QDMA-style descriptor queues.

    Same link as :func:`h100_host_path`, but transfers flow through
    per-function descriptor rings drained by a scheduler: a higher fixed
    setup per op (a scheduling round and a ring doorbell) that the ring
    *coalesces* across batched submissions.  The selector models this as
    a larger ``t0`` amortized over the batch: QDMA loses to XDMA on
    isolated transfers and wins once submissions are deep enough to
    share the scheduling cost (the paper's §4.1.2 contrast).
    """
    return dataclasses.replace(h100_host_path(), t0_us=18.0)


def far_memory_path() -> PathModel:
    """NIC-attached DRAM behind one-sided RDMA verbs (the rmem tier).

    Anchored on a 100 Gb/s RNIC (12.5 GB/s) with the short per-verb
    setup one-sided ops show on off-path SmartNICs (arXiv:2212.07868):
    higher single-op efficiency than a DMA descriptor ring, no H2C/C2H
    asymmetry (both directions are initiator-driven reads/writes of
    remote DRAM).
    """
    return PathModel(link_gbps=12.5, t0_us=3.0, single_eff=0.80,
                     max_eff=0.92, c2h_boost=1.0, contention_factor=0.90)


def doorbell_bandwidth_gbps(m: PathModel, size_bytes: int, batch: int = 1,
                            channels: int = 1,
                            direction: Direction = Direction.C2H,
                            contended: bool = False) -> float:
    """Bandwidth with the per-doorbell setup amortized over ``batch`` ops
    (``size_bytes`` is the size of ONE op)."""
    if batch < 1:
        raise ValueError(batch)
    eff = dataclasses.replace(m, t0_us=m.t0_us / batch)
    return bandwidth_gbps(eff, size_bytes, channels, direction, contended)


def project(measured_gbps: float, ceiling_gbps: float,
            target: PathModel, size_bytes: int, channels: int,
            direction: Direction) -> float:
    """Scale a measurement onto a target path: keep the measured
    *fraction of its ceiling* (on the card, the pinned host->device
    rate) and apply it to the target's modelled bandwidth."""
    frac = min(measured_gbps / max(ceiling_gbps, 1e-9), 1.0)
    return frac * bandwidth_gbps(target, size_bytes, channels, direction)
