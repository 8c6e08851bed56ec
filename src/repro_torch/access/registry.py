"""Path registry: names -> ``MemoryPath`` factories.

Twin of ``repro/access/registry.py`` for this slice: one construction
surface, so callers spell a path as a string and get a fully wired
adapter.  Factories tolerate the union of all paths' keyword arguments:
irrelevant ones are filtered by signature, so ``create_path("xdma",
n_nodes=2)`` simply drops ``n_nodes``.

Registered: ``xdma`` (static DMA channels over host DRAM).  ``qdma``,
``verbs``, ``auto`` and ``fabric`` are not ported yet.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict

from repro_torch.access.adapters import XdmaPath
from repro_torch.access.path import MemoryPath


class PathRegistry:
    """Named ``MemoryPath`` factories with signature-filtered kwargs."""

    def __init__(self):
        self._factories: Dict[str, Callable[..., MemoryPath]] = {}

    def register(self, name: str, factory: Callable[..., MemoryPath],
                 overwrite: bool = False) -> None:
        if name in self._factories and not overwrite:
            raise ValueError(f"path {name!r} already registered")
        self._factories[name] = factory

    def names(self) -> list:
        return sorted(self._factories)

    def create(self, name: str, **kw) -> MemoryPath:
        if name not in self._factories:
            raise ValueError(f"unknown access path {name!r}; "
                             f"registered: {self.names()}")
        factory = self._factories[name]
        params = inspect.signature(factory).parameters
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
            kw = {k: v for k, v in kw.items() if k in params}
        return factory(**kw)


DEFAULT_REGISTRY = PathRegistry()
DEFAULT_REGISTRY.register("xdma", XdmaPath)


def create_path(name: str, **kw) -> MemoryPath:
    """Construct a registered path; see ``PathRegistry.create``."""
    return DEFAULT_REGISTRY.create(name, **kw)
