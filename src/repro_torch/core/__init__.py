"""NMA: the paper's host<->accelerator memory-access engine, on torch.

Public API:
    Descriptor, SGList, gather, spans_for_packing   (scatter-gather model)
    Channel, ChannelPool, Direction, CompletionMode, Transfer (XDMA model)
    FunctionQueue, QueueEngine                      (QDMA queue model)
    MemoryEngine                                    (facade)
    HostOffloadedOptimizer, KVPager, TieredStore    (production offload
                                                     paths, resolved lazily)

``TieredStore`` and the far-memory tier live in ``repro_torch.rmem``;
the offload names resolve lazily so the core<->rmem dependency stays
one-way at import time.
"""
import importlib

from repro_torch.core.channels import (Channel, ChannelPool,  # noqa: F401
                                       CompletionMode, Direction, Transfer)
from repro_torch.core.descriptors import (Descriptor, SGList,  # noqa: F401
                                          gather, spans_for_packing)
from repro_torch.core.engine import MemoryEngine  # noqa: F401
from repro_torch.core.queues import FunctionQueue, QueueEngine  # noqa: F401

_LAZY = {
    "HostOffloadedOptimizer": "repro_torch.core.offload",
    "KVPager": "repro_torch.core.offload",
    "TieredStore": "repro_torch.rmem.store",
}

__all__ = ["Channel", "ChannelPool", "CompletionMode", "Direction",
           "Transfer", "Descriptor", "SGList", "gather",
           "spans_for_packing", "MemoryEngine", "FunctionQueue",
           "QueueEngine", "HostOffloadedOptimizer", "KVPager",
           "TieredStore"]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
