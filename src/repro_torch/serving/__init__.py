"""repro_torch.serving: the batched serving engine of the port.

Public API:
    ServeEngine, Request, summarize_requests

The admission controller, workload generator and fleet router are not
ported yet.
"""
from repro_torch.serving.engine import (Request, ServeEngine,  # noqa: F401
                                        summarize_requests)

__all__ = ["Request", "ServeEngine", "summarize_requests"]
