"""From a traced span to the records the per-layer readers take.

A traced run profiles one span with ``torch.profiler`` (the card's
activity) and the program's own tracer (``repro_torch.obs``) on, and
times and labels the engine's calls with the harness's wrappers.  This
module turns the profiler's events into plain tuples, clipped to the
span (its bounds read on the host in the profiler's clock, Unix
nanoseconds), and pairs the program's begin/end span events.  Nothing
here reads a clock.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
FLASH_KERNELS = ("flash_attention_bf16_kernel", "flash_attention_f32_kernel")
INSTALL_KERNEL = "install_pages_kernel"


@dataclass
class DeviceOp:
    name: str
    start: int          # ns, the profiler's clock
    end: int


@dataclass
class HostEvent:
    """A harness label: what the host was doing, in the profiler's clock."""
    name: str
    start: int
    end: int


@dataclass
class Profile:
    """The profiler's view of the span."""
    start: int
    end: int
    device: List[DeviceOp] = field(default_factory=list)
    host: List[HostEvent] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9


def _is_device_op(e) -> bool:
    """A kernel, copy or set on the card: the profiler's own word where
    it gives one (``activity_type``, newer PyTorch), else any CUDA event
    (the harness records no ``record_function`` label to mirror there)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at() in DEVICE_ACTIVITIES
    return str(e.device_type()).endswith("CUDA")


def _end(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end is not None else e.start_ns() + e.duration_ns()


def from_kineto(events, start_ns: int, end_ns: int,
                host: Sequence[HostEvent] = ()) -> Profile:
    """Reduce ``prof.profiler.kineto_results.events()`` to the device's
    operations, clipped to the span ``[start_ns, end_ns]`` (Unix
    nanoseconds, the profiler's clock, read on the host when the span
    opened and closed), with the host's labels beside them.  Raises when
    the profile's device events lie outside the span: then the two
    clocks disagree and no share can be read."""
    prof = Profile(start_ns, end_ns, host=sorted(host, key=lambda h: h.start))
    outside = 0
    for e in events:
        if not _is_device_op(e):
            continue
        a, b = max(e.start_ns(), start_ns), min(_end(e), end_ns)
        if b > a:
            prof.device.append(DeviceOp(e.name(), a, b))
        else:
            outside += 1
    if outside > max(16, len(prof.device) // 10):
        raise RuntimeError(f"{outside} device events lie outside the span "
                           f"and {len(prof.device)} inside: the profiler's "
                           f"clock is not the host's")
    prof.device.sort(key=lambda d: d.start)
    return prof


def busy_intervals(prof: Profile) -> List[Tuple[int, int]]:
    """The union of the device's kernels, copies and sets, in order."""
    out: List[List[int]] = []
    for d in prof.device:
        if out and d.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], d.end)
        else:
            out.append([d.start, d.end])
    return [(a, b) for a, b in out]


def busy_s(prof: Profile) -> float:
    return sum(b - a for a, b in busy_intervals(prof)) * 1e-9


def idle_gaps(prof: Profile) -> List[Tuple[int, int]]:
    gaps, t = [], prof.start
    for a, b in busy_intervals(prof):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if prof.end > t:
        gaps.append((t, prof.end))
    return gaps


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    s = re.sub(r"^(void|__global__)\s+", "", s)
    return s[:120] or name[:120]


def kernels_named(prof: Profile, names: Sequence[str]) -> List[DeviceOp]:
    return [d for d in prof.device if any(n in d.name for n in names)]


def top_device_ops(prof: Profile, n: int = 10) -> List[list]:
    tot: Dict[str, int] = {}
    for d in prof.device:
        k = short_name(d.name)
        tot[k] = tot.get(k, 0) + (d.end - d.start)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in top]


def _covering(events: List[HostEvent], starts: List[int],
              t: int) -> Optional[HostEvent]:
    """The innermost label of ``events`` (sorted by start) that covers
    ``t``: the latest-starting one that has not ended (labels nest)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if events[i].end >= t:
            return events[i]
        i -= 1
    return None


def top_idle_gaps(prof: Profile, n: int = 10) -> List[list]:
    """The device's idle seconds in the span, by what the host was doing
    at each gap's midpoint: the innermost harness label there."""
    starts = [h.start for h in prof.host]
    tot: Dict[str, int] = {}
    for a, b in idle_gaps(prof):
        lab = _covering(prof.host, starts, (a + b) // 2)
        key = lab.name if lab else "harness, between steps"
        tot[key] = tot.get(key, 0) + (b - a)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in top]


def paired_spans(chrome_events: Sequence[dict], epoch: float,
                 names: Sequence[str]) -> List[dict]:
    """The program tracer's B/E pairs of ``names``, each as
    ``{"name", "t0", "t1", "args"}`` in perf_counter seconds (``epoch``
    is the tracer's origin)."""
    stacks: Dict[int, List[dict]] = {}
    out = []
    for ev in chrome_events:
        ph = ev.get("ph")
        if ph == "B":
            stacks.setdefault(ev["tid"], []).append(ev)
        elif ph == "E":
            st = stacks.get(ev["tid"])
            if not st:
                continue
            b = st.pop()
            if b["name"] in names:
                out.append({"name": b["name"],
                            "t0": epoch + b["ts"] * 1e-6,
                            "t1": epoch + ev["ts"] * 1e-6,
                            "args": b.get("args") or {}})
    out.sort(key=lambda s: s["t0"])
    return out
