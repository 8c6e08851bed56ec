"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``.  Without a card that default raises;
it never carries on on the CPU.  Only an explicit ``"cpu"`` runs there.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None means ``"cuda"``) as a ``torch.device``; raises
    when a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device and none is available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``, read once per
    device (the kernels' launch plans ask on every call)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)
