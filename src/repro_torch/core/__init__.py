"""NMA: the paper's host<->accelerator memory-access engine, on torch.

Public API:
    Descriptor, SGList, gather, spans_for_packing   (scatter-gather model)
    Channel, ChannelPool, Direction, CompletionMode, Transfer (XDMA model)
    FunctionQueue, QueueEngine                      (QDMA queue model)
    MemoryEngine                                    (facade)

``TieredStore`` and the far-memory tier live in ``repro_torch.rmem``.
"""
from repro_torch.core.channels import (Channel, ChannelPool,  # noqa: F401
                                       CompletionMode, Direction, Transfer)
from repro_torch.core.descriptors import (Descriptor, SGList,  # noqa: F401
                                          gather, spans_for_packing)
from repro_torch.core.engine import MemoryEngine  # noqa: F401
from repro_torch.core.queues import FunctionQueue, QueueEngine  # noqa: F401

__all__ = ["Channel", "ChannelPool", "CompletionMode", "Direction",
           "Transfer", "Descriptor", "SGList", "gather",
           "spans_for_packing", "MemoryEngine", "FunctionQueue",
           "QueueEngine"]
