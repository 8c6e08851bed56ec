"""Path registry: names -> ``MemoryPath`` factories.

Twin of ``repro/access/registry.py``: one construction surface, so
callers (CLI flags, ``MemoryEngine``, ``TieredStore``) spell a path as a
string and get a fully wired adapter — or, for ``"auto"``, a
``PathSelector`` over all of them.  Factories tolerate the union of all
paths' keyword arguments: irrelevant ones are filtered by signature, so
``create_path("xdma", n_nodes=2)`` simply drops ``n_nodes``.

Registered:
    xdma   — static DMA channels over host DRAM
    qdma   — descriptor queues over host DRAM
    verbs  — one-sided verbs onto far-memory nodes
    auto   — ``PathSelector`` over the above (page-backed members when
             geometry is given, stage-only xdma+qdma members otherwise)
    fabric — ``ShardedPath`` of N homogeneous members
             (``repro_torch.fabric.create_fabric``; ``member=``,
             ``shards=``, ``replicas=``); its ``**member_kw`` take every
             keyword, ``device`` included, on to each member's factory
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Sequence

from repro_torch.access.adapters import QdmaPath, VerbsPath, XdmaPath
from repro_torch.access.path import MemoryPath
from repro_torch.access.selector import PathSelector


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
DEFAULT_REGISTRY.register("qdma", QdmaPath)
DEFAULT_REGISTRY.register("verbs", VerbsPath)


def _auto_factory(n_pages: int = 0, page_bytes: int = 0,
                  members: Sequence[str] = None,
                  occupancy_penalty: float = 2.0,
                  trace_limit: int = 4096, **kw) -> PathSelector:
    """Selector over member paths sharing one page geometry.

    Stage-only (``n_pages=0``) selectors default to the two DMA members
    — a verbs path with no far memory behind it has nothing distinct to
    offer the host<->device leg.
    """
    if members is None:
        members = ("xdma", "qdma", "verbs") if n_pages else \
            ("xdma", "qdma")
    paths = []
    try:
        for m in members:
            paths.append(DEFAULT_REGISTRY.create(
                m, n_pages=n_pages, page_bytes=page_bytes, **kw))
    except BaseException:
        for p in paths:
            p.close()
        raise
    return PathSelector(paths, occupancy_penalty=occupancy_penalty,
                        trace_limit=trace_limit)


DEFAULT_REGISTRY.register("auto", _auto_factory)


def _fabric_factory(**kw):
    # deferred: repro_torch.fabric imports this module's create_path
    from repro_torch.fabric import create_fabric
    return create_fabric(**kw)


DEFAULT_REGISTRY.register("fabric", _fabric_factory)


def create_path(name: str, **kw) -> MemoryPath:
    """Construct a registered path; see ``PathRegistry.create``."""
    return DEFAULT_REGISTRY.create(name, **kw)
