"""Lightweight tracing: nestable spans, instant events, Chrome export.

One transfer's life crosses every layer this repo has built — serve
admission, the tiered store's miss pipeline, the access-path adapters,
the fabric's replica routing, the verbs doorbells — and until now each
layer only kept private counters.  This module is the seam they all
report into: a process-wide ``Tracer`` holding a bounded in-memory ring
of events, exported as Chrome trace-event JSON (the format Perfetto and
``chrome://tracing`` load directly), so "why was THIS request slow"
becomes a picture instead of a dict diff.

Event vocabulary (DESIGN.md §8):

* ``span(name, **args)`` — a context manager emitting ``B``/``E``
  begin/end pairs on the calling thread's track; spans nest naturally
  because ``with`` blocks are LIFO per thread.
* ``instant(name, **args)`` — a point occurrence (``i`` events): path
  decisions, fabric failovers, epoch bumps, node kills.
* ``complete(name, t0, dur)`` — a retroactive span (``X`` events) for
  operations whose begin was only known at settle time; the reactor
  emits one per completion onto a per-source synthetic track, which is
  how all three access paths and every fabric member get traced for
  free.
* ``async_begin``/``async_end`` — ``b``/``e`` pairs correlated by id
  across threads (the serve request lifecycle, which starts on the
  submitting caller and finishes inside the decode loop).

Disabled-by-default no-op fast path: when no tracer is installed the
module-level helpers cost one global load and a ``None`` check — no
allocation, no locks — so instrumented hot paths stay hot.  ``enable()``
installs the process tracer; ``export()`` writes the JSON.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_TRACER: Optional["Tracer"] = None      # None <=> tracing disabled


class _NullSpan:
    """Shared no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting a B/E pair on the current thread track."""

    __slots__ = ("_tracer", "_name", "_args")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._tracer._emit("B", self._name, self._tracer._thread_track(),
                           time.perf_counter(), None, self._args)
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self._name, self._tracer._thread_track(),
                           time.perf_counter(), None, None)
        return False


def _cat(name: str) -> str:
    """Event category = the layer prefix (``serve.prefill`` -> ``serve``)."""
    return name.split(".", 1)[0].split("#", 1)[0]


class Tracer:
    """Bounded in-memory event ring with Chrome trace-event export.

    Events are stored as compact tuples ``(ph, name, track_id, ts_us,
    dur_us, args, id)``; export materializes the JSON dicts.  When the
    ring is full the oldest events drop (counted in ``dropped``) — a
    trace is a window, not an archive.
    """

    def __init__(self, limit: int = 1 << 16):
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        self.limit = limit
        self._events: deque = deque(maxlen=limit)
        self._lock = threading.Lock()
        self._tracks: Dict[Any, int] = {}       # key -> track id
        self._track_names: Dict[int, str] = {}
        self.epoch = time.perf_counter()        # ts origin for the trace
        self.dropped = 0

    # -- tracks ----------------------------------------------------------
    def _track(self, key: Any, label: str) -> int:
        with self._lock:
            tid = self._tracks.get(key)
            if tid is None:
                tid = len(self._tracks) + 1
                self._tracks[key] = tid
                self._track_names[tid] = label
            return tid

    def _thread_track(self) -> int:
        t = threading.current_thread()
        return self._track(t.ident, t.name)

    # -- emission --------------------------------------------------------
    def _emit(self, ph: str, name: str, track: int, t_s: float,
              dur_s: Optional[float], args: Optional[dict],
              id_: Optional[int] = None) -> None:
        ts_us = (t_s - self.epoch) * 1e6
        dur_us = None if dur_s is None else dur_s * 1e6
        with self._lock:
            if len(self._events) == self.limit:
                self.dropped += 1
            self._events.append((ph, name, track, ts_us, dur_us, args, id_))

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._emit("i", name, self._thread_track(), time.perf_counter(),
                   None, args or None)

    def complete(self, name: str, t0_s: float, dur_s: float,
                 track: Optional[str] = None,
                 args: Optional[dict] = None) -> None:
        """Retroactive span: ``[t0_s, t0_s + dur_s]`` in perf_counter
        seconds, on a named synthetic track (default: calling thread).
        Synthetic tracks may carry overlapping spans (a source with
        in-flight > 1), which is why they are ``X`` events, not B/E."""
        tid = self._thread_track() if track is None else \
            self._track(("synthetic", track), track)
        self._emit("X", name, tid, t0_s, dur_s, args)

    def async_begin(self, name: str, id_: int, **args) -> None:
        self._emit("b", name, self._thread_track(), time.perf_counter(),
                   None, args or None, id_=id_)

    def async_end(self, name: str, id_: int, **args) -> None:
        self._emit("e", name, self._thread_track(), time.perf_counter(),
                   None, args or None, id_=id_)

    # -- export ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto- and
        chrome://tracing-loadable): ``B``/``E`` thread spans, ``X``
        retroactive spans, ``i`` instants, ``b``/``e`` async pairs, plus
        ``M`` metadata rows naming every track."""
        with self._lock:
            events = list(self._events)
            names = dict(self._track_names)
        out: List[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "repro"}}]
        for tid, label in sorted(names.items()):
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name", "args": {"name": label}})
        for ph, name, tid, ts_us, dur_us, args, id_ in events:
            ev: dict = {"ph": ph, "name": name, "cat": _cat(name),
                        "pid": 1, "tid": tid, "ts": ts_us}
            if dur_us is not None:
                ev["dur"] = dur_us
            if ph == "i":
                ev["s"] = "t"               # thread-scoped instant
            if id_ is not None:
                ev["id"] = id_
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns #events."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f, default=_json_default)
        return len(trace["traceEvents"])


def _json_default(obj):
    """Args may carry numpy scalars / enums; degrade them readably."""
    for attr in ("item", "value", "name"):
        v = getattr(obj, attr, None)
        if v is not None:
            return v() if callable(v) else v
    return str(obj)


# -- module-level API (the no-op fast path) -------------------------------
def enable(limit: int = 1 << 16) -> Tracer:
    """Install (or replace) the process tracer; returns it."""
    global _TRACER
    _TRACER = Tracer(limit=limit)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **args):
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **args)


def complete(name: str, t0_s: float, dur_s: float,
             track: Optional[str] = None,
             args: Optional[dict] = None) -> None:
    t = _TRACER
    if t is not None:
        t.complete(name, t0_s, dur_s, track=track, args=args)


def async_begin(name: str, id_: int, **args) -> None:
    t = _TRACER
    if t is not None:
        t.async_begin(name, id_, **args)


def async_end(name: str, id_: int, **args) -> None:
    t = _TRACER
    if t is not None:
        t.async_end(name, id_, **args)


def export(path: str) -> int:
    """Export the current trace; raises if tracing is disabled."""
    t = _TRACER
    if t is None:
        raise RuntimeError("tracing is disabled (obs.trace.enable() first)")
    return t.export(path)
