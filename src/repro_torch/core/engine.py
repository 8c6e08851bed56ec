"""Unified NMA engine facade — a thin veneer over ``repro_torch.access``.

Twin of ``repro/core/engine.py``.  ``MemoryEngine`` keeps the
host<->device array surface (``write``/``read``) and delegates every
transfer to a ``MemoryPath`` from the access registry: the XDMA channel
pool, the QDMA queue engine, or a model-driven ``PathSelector``
(``path="auto"``) that picks per transfer.

    eng = MemoryEngine(n_channels=4, path="qdma", device="cuda")
    dev = eng.write(host_array).wait()   # H2C
    host = eng.read(dev_tensor).wait()   # C2H

Pass a constructed ``MemoryPath`` as ``path=`` to share one path between
the engine and other subsystems; the engine only closes paths it
created.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch import obs
from repro_torch.core.channels import CompletionMode, Transfer


class MemoryEngine:
    def __init__(self, n_channels: int = 4, path="xdma",
                 device=None, chunk_bytes: int = 1 << 22,
                 mode: CompletionMode = CompletionMode.POLLED):
        if isinstance(path, str):
            # deferred: repro_torch.access imports core submodules, so
            # importing it at this module's top would cycle
            from repro_torch.access.registry import create_path
            self.path = create_path(path, n_channels=n_channels,
                                    device=device, chunk_bytes=chunk_bytes,
                                    mode=mode)
            self._owns_path = True
        else:
            self.path = path
            self._owns_path = False
        self.mode = mode
        self._closed = False

    # the underlying mechanism's handles, for callers that tune them
    @property
    def pool(self):
        return getattr(self.path, "pool", None)

    @property
    def qdma(self):
        return getattr(self.path, "qdma", None)

    def write(self, host_arr, on_complete: Optional[Callable] = None,
              qname: str = "default") -> Transfer:
        return self.path.stage_h2c(host_arr, on_complete=on_complete,
                                   qname=qname)

    def read(self, dev_arr, on_complete: Optional[Callable] = None,
             qname: str = "default") -> Transfer:
        return self.path.stage_c2h(dev_arr, on_complete=on_complete,
                                   qname=qname)

    def stats(self) -> dict:
        """The path's unified ``{path, bytes_moved, ops, projected_s,
        ...}`` schema (mechanism detail nests below)."""
        return obs.export_stats("engine", self.path.stats())

    def close(self) -> None:
        """Idempotent; only closes a path this engine constructed."""
        if self._closed:
            return
        self._closed = True
        if self._owns_path:
            self.path.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
