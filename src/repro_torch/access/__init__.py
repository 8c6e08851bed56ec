"""repro_torch.access: the capability-typed memory-access API.

The unification layer over the three access stacks — XDMA channels, QDMA
descriptor queues and RDMA-style verbs — plus the model-driven selector
that picks among them per request.

Public API:
    MemoryPath, PathCapabilities            (the protocol + descriptor)
    XdmaPath, QdmaPath, VerbsPath           (adapters over the stacks)
    PathRegistry, DEFAULT_REGISTRY, create_path
    PathSelector, PathDecision              (policy + decision trace)
"""
from repro_torch.access.adapters import (QdmaPath, VerbsPath,  # noqa: F401
                                         XdmaPath)
from repro_torch.access.path import MemoryPath, PathCapabilities  # noqa: F401
from repro_torch.access.registry import (DEFAULT_REGISTRY,  # noqa: F401
                                         PathRegistry, create_path)
from repro_torch.access.selector import (PathDecision,  # noqa: F401
                                         PathSelector)

__all__ = ["MemoryPath", "PathCapabilities",
           "XdmaPath", "QdmaPath", "VerbsPath",
           "PathRegistry", "DEFAULT_REGISTRY", "create_path",
           "PathSelector", "PathDecision"]
