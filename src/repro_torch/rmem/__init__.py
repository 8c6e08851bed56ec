"""rmem: the cold tier, the far-memory tier and the tiered store, on torch.

Public API:
    MemoryRegion, QueuePair, CompletionQueue, WorkCompletion  (verbs)
    MemoryNode, AddressMap, MapEntry                          (memory nodes)
    TierBackend, LocalHostBackend, RemoteBackend, make_backend (backends)
    PendingIO                                  (async batched tier handle)
    TieredStore                                (device slots over a tier)
"""
from repro_torch.rmem.backend import (LocalHostBackend,  # noqa: F401
                                      PendingIO, RemoteBackend, TierBackend,
                                      make_backend)
from repro_torch.rmem.node import AddressMap, MapEntry, MemoryNode  # noqa: F401
from repro_torch.rmem.store import TieredStore  # noqa: F401
from repro_torch.rmem.verbs import (CompletionQueue,  # noqa: F401
                                    MemoryRegion, OpCode, QueuePair,
                                    WCStatus, WorkCompletion)

__all__ = [
    "MemoryRegion", "QueuePair", "CompletionQueue", "WorkCompletion",
    "OpCode", "WCStatus",
    "MemoryNode", "AddressMap", "MapEntry",
    "TierBackend", "LocalHostBackend", "RemoteBackend", "make_backend",
    "PendingIO", "TieredStore",
]
