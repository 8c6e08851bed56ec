"""repro_torch.access: the capability-typed memory-access API.

Public API:
    MemoryPath, PathCapabilities       (the protocol + descriptor)
    XdmaPath                           (the adapter ported so far)
    PathRegistry, DEFAULT_REGISTRY, create_path
"""
from repro_torch.access.adapters import XdmaPath  # noqa: F401
from repro_torch.access.path import MemoryPath, PathCapabilities  # noqa: F401
from repro_torch.access.registry import (DEFAULT_REGISTRY,  # noqa: F401
                                         PathRegistry, create_path)

__all__ = ["MemoryPath", "PathCapabilities", "XdmaPath",
           "PathRegistry", "DEFAULT_REGISTRY", "create_path"]
