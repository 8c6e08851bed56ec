"""NMA: the paper's host<->accelerator memory-access engine, on torch.

Public API:
    Channel, ChannelPool, Direction, CompletionMode, Transfer (XDMA model)
    MemoryEngine                                             (facade)

``TieredStore`` lives in ``repro_torch.rmem``.
"""
from repro_torch.core.channels import (Channel, ChannelPool,  # noqa: F401
                                       CompletionMode, Direction, Transfer)
from repro_torch.core.engine import MemoryEngine  # noqa: F401

__all__ = ["Channel", "ChannelPool", "CompletionMode", "Direction",
           "Transfer", "MemoryEngine"]
