"""Kernel tour on the card: flash attention, tiered stream copy, RG-LRU
scan, each against its plain PyTorch version.

Twin of ``examples/pallas_kernels.py``.  Inputs are drawn with numpy
from seed 0: q (2, 256, 8, 64), k and v (2, 256, 2, 64) float32 for
causal GQA flash attention; a (512, 512) float32 input copied through
1, 2 and 4 in-flight buffers of 64 rows; a in [0.8, 0.999) and b normal,
(2, 128, 256) float32, for the RG-LRU scan.  On the card each CUDA
kernel runs and is held to its plain version: flash within 2e-5 (abs +
rel, float32), the copy byte for byte, the scan bit for bit (both are
the same sequence of rounded float32 operations).  With ``--device cpu``
the wrappers run the plain versions themselves.

    python -m repro_torch.examples.kernels [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

FLASH_TOL = 2e-5


def inputs(seed: int = 0) -> dict:
    """The tour's numpy inputs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"q": rng.standard_normal((2, 256, 8, 64)).astype(f32),
            "k": rng.standard_normal((2, 256, 2, 64)).astype(f32),
            "v": rng.standard_normal((2, 256, 2, 64)).astype(f32),
            "x": rng.standard_normal((512, 512)).astype(f32),
            "a": rng.uniform(0.8, 0.999, (2, 128, 256)).astype(f32),
            "b": rng.standard_normal((2, 128, 256)).astype(f32)}


def run(device=None, seed: int = 0) -> dict:
    """Run each kernel and hold it to its plain version; returns the
    outputs (on the CPU) and the errors."""
    dev = resolve_device(device)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inputs(seed).items()}

    out = ops.flash_attention(t["q"], t["k"], t["v"])
    ref = ops.attention_ref(t["q"], t["k"], t["v"])
    flash_err = float((out - ref).abs().max())
    print(f"flash_attention: out {tuple(out.shape)}, max|err| "
          f"{flash_err:.2e}", flush=True)
    if bool(((out - ref).abs() > FLASH_TOL + FLASH_TOL * ref.abs()).any()):
        raise AssertionError(f"flash_attention differs from its plain "
                             f"version beyond {FLASH_TOL}: {flash_err}")

    want = t["x"].view(torch.int32)
    for nb in (1, 2, 4):
        y = ops.stream_copy(t["x"], block_rows=64, n_buffers=nb)
        if not torch.equal(y.view(torch.int32), want):
            raise AssertionError(f"stream_copy n_buffers={nb}: bytes differ")
    print("stream_copy: identity holds for 1/2/4 in-flight buffers "
          "(buffers = the paper's DMA channel count)", flush=True)

    h = ops.rg_lru_scan(t["a"], t["b"])
    href = ops.rg_lru_scan_ref(t["a"], t["b"])
    lru_err = float((h - href).abs().max())
    print(f"rg_lru_scan: out {tuple(h.shape)}, max|err| {lru_err:.2e}",
          flush=True)
    if not torch.equal(h, href):
        raise AssertionError(f"rg_lru_scan is not bit-equal to its plain "
                             f"version (max abs err {lru_err})")
    return {"flash": out.cpu(), "rg_lru": h.cpu(), "flash_err": flash_err,
            "rg_lru_err": lru_err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
