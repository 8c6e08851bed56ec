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

The port's host path is ``h100_host_path``; the paper's own FPGA paths
stay for reference.  No TPU part is modelled here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.channels import Direction

# Pinned host->device copy rate that ``chip_smoke.py`` measured on an
# NVIDIA H100 80GB HBM3 (power limit 700.00 W): one 64 MiB copy, median
# of 10.  The link ceiling of ``h100_host_path``.
H100_PINNED_H2D_GBPS = 51.954


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
