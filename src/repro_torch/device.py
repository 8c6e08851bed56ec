"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``.  Without a card that default raises;
it never carries on on the CPU.  Only an explicit ``"cpu"`` runs there.

``traced`` tells the kernel wrappers when a call is watched rather than
run: a meta tensor or a FakeTensor (the cost pass, ``launch/dryrun.py``)
or a dispatch mode on the stack (a FLOP or memory count,
``launch/hlo.py``).  Such a call goes through the kernel's
``torch.library`` op so that the mode sees it as one op with the
kernel's output; an unwatched call launches directly, since the
dispatcher costs host time on every call.
"""
from __future__ import annotations

import functools
import sys

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


def is_fake(t) -> bool:
    """Whether ``t`` is a FakeTensor; its module is not imported for the
    asking."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and isinstance(t, mod.FakeTensor)


def traced(t: torch.Tensor) -> bool:
    """Whether a kernel call on ``t`` must go through its op (module
    note): ``t`` is a meta tensor or a FakeTensor, or a dispatch mode is
    on the stack."""
    return (t.device.type == "meta"
            or torch._C._len_torch_dispatch_stack() > 0 or is_fake(t))
