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
created.  The old ``flavor="xdma"|"qdma"`` spelling still works but
emits a ``DeprecationWarning``.

Tree helpers move whole param/optimizer-state trees (offload,
checkpoint), leaves in jax's flatten order (``interop.tree_flatten``).
A host tree holds CPU tensors where the reference's holds numpy arrays:
numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf crosses C2H
as its 16-bit pattern and comes back as a bf16 CPU tensor, every bit
kept.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.channels import CompletionMode, Transfer
from repro_torch.interop import tree_flatten, tree_unflatten

# dtypes numpy lacks: a C2H moves them as same-width integers
_BIT_VIEWS = {torch.bfloat16: torch.int16}


def c2h_leaf(engine, dev: torch.Tensor, **kw):
    """Start the C2H of one device tensor on ``engine``; returns
    ``(transfer, finish)``, where ``finish(transfer.wait())`` is the
    host copy as a CPU tensor of ``dev``'s dtype."""
    bits = _BIT_VIEWS.get(dev.dtype)
    tr = engine.read(dev if bits is None else dev.view(bits), **kw)

    def finish(host):
        t = torch.from_numpy(np.asarray(host)) \
            if not isinstance(host, torch.Tensor) else host
        return t if bits is None else t.view(dev.dtype)
    return tr, finish


class MemoryEngine:
    def __init__(self, n_channels: int = 4, path="xdma",
                 device=None, chunk_bytes: int = 1 << 22,
                 mode: CompletionMode = CompletionMode.POLLED,
                 flavor: Optional[str] = None):
        if flavor is not None:
            warnings.warn(
                "MemoryEngine(flavor=...) is deprecated; use "
                "MemoryEngine(path=...) — same names, plus 'verbs' and "
                "'auto' from the access registry", DeprecationWarning,
                stacklevel=2)
            path = flavor
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
        self.flavor = self.path.name        # established introspection name
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

    # -- trees ----------------------------------------------------------------
    def write_tree(self, host_tree) -> Any:
        """H2C every leaf (numpy arrays or CPU tensors); the device tree."""
        leaves, spec = tree_flatten(host_tree)
        trs = [self.write(l) for l in leaves]
        return tree_unflatten(spec, [t.wait() for t in trs])

    def read_tree(self, dev_tree) -> Any:
        """C2H every leaf; the host tree of CPU tensors."""
        return self.read_tree_async(dev_tree)()

    def read_tree_async(self, dev_tree) -> Callable[[], Any]:
        """Start a C2H drain; returns a join() producing the host tree."""
        leaves, spec = tree_flatten(dev_tree)
        join = self.read_leaves_async(leaves)
        return lambda: tree_unflatten(spec, join())

    def read_leaves_async(self, leaves) -> Callable[[], List[Any]]:
        """Start the C2H of every tensor of ``leaves``; returns a join()
        producing their host copies (CPU tensors), in order."""
        started = [c2h_leaf(self, l) for l in leaves]
        return lambda: [fin(tr.wait()) for tr, fin in started]

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
