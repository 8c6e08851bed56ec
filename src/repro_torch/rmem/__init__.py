"""rmem: the cold tier and the tiered store, on torch.

Public API:
    TierBackend, LocalHostBackend, PendingIO   (host-DRAM cold tier)
    TieredStore                                (device slots over it)

The far-memory half (verbs, memory nodes, ``RemoteBackend``) and the
page codecs are not ported yet.
"""
from repro_torch.rmem.backend import (LocalHostBackend,  # noqa: F401
                                      PendingIO, TierBackend)
from repro_torch.rmem.store import TieredStore  # noqa: F401

__all__ = ["TierBackend", "LocalHostBackend", "PendingIO", "TieredStore"]
