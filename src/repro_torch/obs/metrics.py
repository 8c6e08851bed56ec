"""Process-wide metrics: counters, gauges, log-bucketed histograms.

The DPU characterization literature reads these systems through per-op
latency *distributions*, not means — a p99 under contention is the
number the paper's path-selection question is actually about.  This
module is the repo's one metrics plane:

* ``Counter`` / ``Gauge`` — monotonic and point-in-time scalars;
* ``LogHistogram`` — an HDR/DDSketch-style log-bucketed histogram with
  a *bounded relative error*: every recorded value lands in bucket
  ``ceil(log_gamma(v))`` where ``gamma = (1+r)/(1-r)``, and
  ``percentile(p)`` returns an estimate within ``r`` of the exact order
  statistic, at O(#buckets) memory whatever the sample count.  Two
  histograms with the same ``rel_err`` merge exactly (bucket-count
  addition — associative by construction);
* ``MetricsRegistry`` — a named, typed registry with a ``snapshot()``
  every bench/serve result can embed.

``default_registry()`` is the process-wide instance.  Hot-path *wiring*
(the reactor recording a histogram sample per completion, ``stats()``
dicts mirroring into gauges) is additionally gated behind the
``live()`` switch so the disabled default costs one bool check.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, Optional, Tuple, Union

_LIVE = False                   # hot-path wiring switch (not the registry)


def enable_live() -> None:
    """Turn on hot-path metric wiring (reactor samples, stats mirrors)."""
    global _LIVE
    _LIVE = True


def disable_live() -> None:
    global _LIVE
    _LIVE = False


def live() -> bool:
    return _LIVE


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        return self._value


class Gauge:
    """Point-in-time scalar (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += dv

    @property
    def value(self) -> float:
        return self._value


class LogHistogram:
    """Log-bucketed histogram with bounded relative error (DDSketch-style).

    Bucket ``i`` covers ``(gamma^(i-1), gamma^i]`` with ``gamma =
    (1+rel_err)/(1-rel_err)``; the bucket estimate ``2*gamma^i/(gamma+1)
    = gamma^i*(1-rel_err)`` is within ``rel_err`` (relatively) of every
    value in the bucket.  Values below ``min_trackable`` (and zeros)
    collapse into a dedicated zero bucket reported as ``0.0``.  Only
    non-negative values are accepted — this is a latency/size histogram.
    """

    __slots__ = ("rel_err", "_gamma", "_log_gamma", "min_trackable",
                 "_lock", "_buckets", "_zero", "count", "sum",
                 "_min", "_max")

    def __init__(self, rel_err: float = 0.01,
                 min_trackable: float = 1e-12):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self.min_trackable = min_trackable
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -------------------------------------------------------
    def record(self, value: float) -> None:
        v = float(value)
        if not v >= 0.0:            # rejects negatives AND NaN
            raise ValueError(f"histogram values must be >= 0, got {value}")
        with self._lock:
            self.count += 1
            self.sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if v < self.min_trackable:
                self._zero += 1
            else:
                i = math.ceil(math.log(v) / self._log_gamma)
                self._buckets[i] = self._buckets.get(i, 0) + 1

    # -- queries ---------------------------------------------------------
    @property
    def min(self) -> float:
        return 0.0 if self.count == 0 else self._min

    @property
    def max(self) -> float:
        return 0.0 if self.count == 0 else self._max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def _estimate(self, i: int) -> float:
        return 2.0 * self._gamma ** i / (self._gamma + 1.0)

    def percentile(self, p: float) -> float:
        """Estimate of the ``p``-th percentile (0..100) as an order
        statistic (numpy's ``inverted_cdf``: the sample of 1-based rank
        ``ceil(p/100 * count)``), within ``rel_err`` relative error."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = min(max(math.ceil(p / 100.0 * self.count), 1),
                       self.count)
            cum = self._zero
            if cum >= rank:
                return 0.0
            for i in sorted(self._buckets):
                cum += self._buckets[i]
                if cum >= rank:
                    # clamp into the observed range: a bucket estimate
                    # may overshoot the true extreme by < rel_err
                    return min(max(self._estimate(i), self._min),
                               self._max)
            return self._max        # unreachable unless counts desynced

    # -- merge (exact, associative) --------------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into ``self`` (bucket-count addition — exact
        and associative).  Requires identical bucket geometry."""
        if not isinstance(other, LogHistogram):
            raise TypeError(type(other))
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different rel_err "
                f"({self.rel_err} vs {other.rel_err})")
        # snapshot other first: consistent even if other is being fed
        with other._lock:
            buckets = dict(other._buckets)
            zero, count = other._zero, other.count
            total, mn, mx = other.sum, other._min, other._max
        with self._lock:
            for i, c in buckets.items():
                self._buckets[i] = self._buckets.get(i, 0) + c
            self._zero += zero
            self.count += count
            self.sum += total
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)
        return self

    def copy(self) -> "LogHistogram":
        return LogHistogram(self.rel_err,
                            min_trackable=self.min_trackable).merge(self)

    def summary(self) -> dict:
        """The embeddable snapshot: count/sum/mean/min/max + p50/p95/p99."""
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


Metric = Union[Counter, Gauge, LogHistogram]


class MetricsRegistry:
    """Named, typed metric registry (create-on-first-use, thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, name: str, cls, *args) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(*args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, rel_err: float = 0.01) -> LogHistogram:
        return self._get_or_create(name, LogHistogram, rel_err)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Every metric's current value: scalars for counters/gauges,
        ``summary()`` dicts (with percentiles) for histograms."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in sorted(items):
            out[name] = m.summary() if isinstance(m, LogHistogram) \
                else m.value
        return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every layer reports into by default."""
    return _DEFAULT


def _flatten(prefix: str, d: dict) -> Iterator[Tuple[str, float]]:
    for k, v in d.items():
        name = f"{prefix}.{k}"
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            yield name, v
        elif isinstance(v, dict):
            yield from _flatten(name, v)


def export_stats(prefix: str, stats: dict,
                 registry: Optional[MetricsRegistry] = None) -> dict:
    """Mirror a legacy ``stats()`` dict into registry gauges.

    Every numeric leaf (nested dicts flatten with dots) lands in a gauge
    named ``<prefix>.<dotted.key>`` — the one naming scheme DESIGN.md §8
    documents — while the dict itself is returned unchanged, so the
    established keys stay as aliases for existing tests and benches.
    No-op unless ``live()`` (callers wrap their stats() return in this).
    """
    if not _LIVE:
        return stats
    reg = registry if registry is not None else _DEFAULT
    for name, v in _flatten(prefix, stats):
        reg.gauge(name).set(v)
    return stats
