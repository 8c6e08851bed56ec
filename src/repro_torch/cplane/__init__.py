"""repro_torch.cplane: the one completion plane (DESIGN.md §6).

Every async primitive in the repo — XDMA channel transfers, QDMA work
items, verbs doorbells/completion queues, tier ``PendingIO`` handles —
settles a ``Completion`` and reports into a ``Reactor`` source.  One
wait semantics (timeout, deadline, cancel, callbacks), one composition
surface (``wait_any``/``wait_all``/``as_completed`` across heterogeneous
producers), one telemetry stream (per-source latency/in-flight EWMAs)
that feeds the measured term of ``access.PathSelector``.

Public API:
    Completion, CompletionState                 (the handle)
    CompletionTimeout, CompletionCancelled      (the two exceptions)
    wait_any, wait_all, as_completed            (composition)
    Reactor, SourceTelemetry, default_reactor   (delivery + telemetry)
"""
from repro_torch.cplane.completion import (Completion, CompletionCancelled,
                                     CompletionState, CompletionTimeout,
                                     as_completed, wait_all, wait_any)
from repro_torch.cplane.reactor import Reactor, SourceTelemetry, default_reactor

__all__ = [
    "Completion", "CompletionState",
    "CompletionTimeout", "CompletionCancelled",
    "wait_any", "wait_all", "as_completed",
    "Reactor", "SourceTelemetry", "default_reactor",
]
