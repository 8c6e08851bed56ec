"""repro_torch.obs: one tracing + metrics plane for every layer (DESIGN.md §8).

* ``obs.trace`` — nestable spans, instant events, retroactive completion
  spans, Chrome trace-event JSON export (Perfetto-loadable).  Disabled
  by default; ``obs.trace.enable()`` installs the process tracer.
* ``obs.metrics`` — counters / gauges / log-bucketed ``LogHistogram``
  (bounded relative error, mergeable) in a process-wide registry;
  ``obs.metrics.enable_live()`` additionally turns on hot-path wiring
  (per-completion reactor samples, ``stats()`` gauge mirrors).

The module-level helpers (``obs.span``, ``obs.instant``, ...) are the
instrumentation surface the rest of the repo calls; while everything is
disabled they cost one global load and a ``None``/bool check.
"""
from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (Counter, Gauge, LogHistogram,
                               MetricsRegistry, default_registry,
                               export_stats)
from repro_torch.obs.trace import (Tracer, async_begin, async_end, complete,
                             get_tracer, instant, span)


def active() -> bool:
    """True when any hot-path wiring should run (tracing or live
    metrics) — the single check instrumented fast paths gate on."""
    return trace._TRACER is not None or metrics._LIVE


__all__ = [
    "trace", "metrics", "active",
    "span", "instant", "complete", "async_begin", "async_end",
    "Tracer", "get_tracer",
    "Counter", "Gauge", "LogHistogram", "MetricsRegistry",
    "default_registry", "export_stats",
]
