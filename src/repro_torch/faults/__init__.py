"""repro_torch.faults — deterministic fault injection, typed retry/backoff,
and end-to-end page integrity for the memory plane.

Three pieces, one contract (DESIGN.md §9):

* ``injector`` — a seedable ``FaultPlan`` installed process-wide behind
  the ``injector.ACTIVE`` zero-overhead gate; hooks live in
  ``MemoryNode``, ``LocalHostBackend`` and the verbs completion queue.
* ``retry`` — the ``TransientIOError`` hierarchy and ``RetryPolicy``
  (bounded, budget-capped, deterministically jittered backoff) shared
  by every ``MemoryPath`` page op and ``StepGuard``.
* ``integrity`` — ``PageChecksums`` stamped on store / verified on
  fetch in ``TieredStore`` and ``ShardedPath``; corruption triggers
  replica fallback, ``FabricManager.scrub()`` repairs bad replicas.
"""
from repro_torch.faults import injector
from repro_torch.faults.injector import FaultPlan
from repro_torch.faults.integrity import IntegrityError, PageChecksums, page_crc
from repro_torch.faults.retry import (RETRIABLE, InjectedTimeout, NodeUnavailable,
                                RetryPolicy, TransientCompletionError,
                                TransientIOError, is_transient, retry_io)

__all__ = [
    "injector", "FaultPlan",
    "IntegrityError", "PageChecksums", "page_crc",
    "RETRIABLE", "InjectedTimeout", "NodeUnavailable", "RetryPolicy",
    "TransientCompletionError", "TransientIOError", "is_transient",
    "retry_io",
]
