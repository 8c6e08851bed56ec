"""Seeded open-loop traffic: arrival processes and per-tenant request
mixes.

Twin of ``repro/serving/workload.py``, its own copy of the numpy code:
the same streams give bit-identical schedules and prompt bytes.

The old drain-loop benchmarks were *closed-loop*: N identical requests
submitted at t=0, so nothing ever queued, shed, or missed an SLO.  An
open-loop generator decouples offered load from service capacity — the
arrival process keeps producing whether or not the fleet keeps up —
which is the only regime where admission policy and tail latency mean
anything.

Everything is deterministic under a seed, as ``repro_torch.faults`` is:
each stream draws from its own ``numpy`` Generator seeded by
``crc32(f"{seed}:{name}")``, so the arrival schedule, tenant assignment
and request shapes are bit-identical run to run regardless of how the
consumer interleaves draws, and two processes sharing one seed do not
perturb each other.

Three arrival processes (plus the degenerate burst):

* ``poisson:RATE``              — exponential i.i.d. gaps (M/·/·),
* ``bursty:RATE[:BURST[:CALM]]`` — a 2-state Markov-modulated Poisson
  process (MMPP-2): the chain flips between a calm state and a burst
  state whose instantaneous rates are ``RATE*CALM`` / ``RATE*BURST``,
  chosen so the *mean* rate is still ``RATE`` — same offered load,
  heavier tail,
* ``diurnal:RATE[:PERIOD[:DEPTH]]`` — a sinusoidally-modulated rate
  ``RATE*(1 + DEPTH*sin(2πt/PERIOD))`` via thinning, the classic
  day/night cycle compressed to a benchmark-sized period.

Request mixes draw per-request prompt/decode lengths from a lognormal
over a tenant's characteristic scale — tenants built from the
``configs/`` zoo get shapes matching their family (an ssm/recurrent
arch serves decode-heavy streams, a VLM prompt-heavy multimodal fills,
a MoE long balanced chats).  The *model served* is the caller's; the
zoo only shapes the traffic.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.serving.engine import Request


def _stream(seed: int, name: str) -> np.random.Generator:
    """An independent deterministic stream: same idiom as
    ``repro_torch.faults`` (per-scope crc32 sub-seed), so streams never
    perturb each other and schedules are stable across runs."""
    return np.random.default_rng(zlib.crc32(f"{seed}:{name}".encode()))


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------

class ArrivalProcess:
    """Yields monotone arrival times (seconds from t=0)."""

    name = "base"

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class BurstArrivals(ArrivalProcess):
    """All requests at t=0 — the legacy closed-loop burst, kept as the
    degenerate member so one code path serves both regimes."""

    name = "burst"

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return np.zeros(n, np.float64)


class PoissonArrivals(ArrivalProcess):
    name = "poisson"

    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {rate}")
        self.rate = float(rate)

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return np.cumsum(gaps)

    def describe(self) -> str:
        return f"poisson:{self.rate:g}"


class BurstyArrivals(ArrivalProcess):
    """2-state MMPP: mean rate stays ``rate``; the modulating chain
    spends ``p_up/(p_up+p_down)`` of transitions in the burst state."""

    name = "bursty"

    def __init__(self, rate: float, burst: float = 4.0,
                 calm: Optional[float] = None, p_up: float = 0.15,
                 p_down: float = 0.35):
        if rate <= 0:
            raise ValueError(f"bursty rate must be > 0, got {rate}")
        if burst <= 1.0:
            raise ValueError(f"burst factor must be > 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.p_up = float(p_up)
        self.p_down = float(p_down)
        # pick calm so the long-run mean rate is exactly `rate` unless
        # overridden: with the chain flipping per event, a fraction
        # `frac` of events draws at rate*burst and the rest at
        # rate*calm, so mean time per event is
        # (1-frac)/(rate*calm) + frac/(rate*burst); setting its inverse
        # to `rate` gives calm = (1-frac) / (1 - frac/burst)
        frac = p_up / (p_up + p_down)
        if calm is None:
            calm = (1.0 - frac) / (1.0 - frac / burst)
            calm = max(calm, 0.05)
        if calm >= burst:
            raise ValueError(f"calm factor {calm} must be < burst {burst}")
        self.calm = float(calm)

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        out = np.empty(n, np.float64)
        t, hot = 0.0, False
        for i in range(n):
            r = self.rate * (self.burst if hot else self.calm)
            t += rng.exponential(1.0 / r)
            out[i] = t
            flip = rng.random()
            if hot and flip < self.p_down:
                hot = False
            elif not hot and flip < self.p_up:
                hot = True
        return out

    def describe(self) -> str:
        return f"bursty:{self.rate:g}:{self.burst:g}:{self.calm:g}"


class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal rate ``rate*(1+depth*sin(2πt/period))`` by thinning a
    homogeneous Poisson stream at the envelope rate."""

    name = "diurnal"

    def __init__(self, rate: float, period_s: float = 8.0,
                 depth: float = 0.8):
        if rate <= 0:
            raise ValueError(f"diurnal rate must be > 0, got {rate}")
        if not 0.0 <= depth < 1.0:
            raise ValueError(f"diurnal depth must be in [0,1), got {depth}")
        if period_s <= 0:
            raise ValueError(f"diurnal period must be > 0, got {period_s}")
        self.rate = float(rate)
        self.period_s = float(period_s)
        self.depth = float(depth)

    def rate_at(self, t: float) -> float:
        return self.rate * (1.0 + self.depth *
                            math.sin(2.0 * math.pi * t / self.period_s))

    def times(self, n: int, rng: np.random.Generator) -> np.ndarray:
        env = self.rate * (1.0 + self.depth)
        out = np.empty(n, np.float64)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / env)
            if rng.random() * env <= self.rate_at(t):
                out[i] = t
                i += 1
        return out

    def describe(self) -> str:
        return (f"diurnal:{self.rate:g}:{self.period_s:g}:"
                f"{self.depth:g}")


def parse_arrivals(spec: str) -> ArrivalProcess:
    """Parse the CLI spelling: ``burst``, ``poisson:RATE``,
    ``bursty:RATE[:BURST[:CALM]]``, ``diurnal:RATE[:PERIOD[:DEPTH]]``."""
    parts = spec.split(":")
    kind = parts[0]
    try:
        nums = [float(p) for p in parts[1:]]
    except ValueError:
        raise ValueError(f"bad --arrivals spec {spec!r}: non-numeric "
                         "parameter") from None
    if kind == "burst":
        if nums:
            raise ValueError(f"bad --arrivals spec {spec!r}: burst takes "
                             "no parameters")
        return BurstArrivals()
    if not nums:
        raise ValueError(f"bad --arrivals spec {spec!r}: {kind} needs a "
                         "rate, e.g. {kind}:8")
    if kind == "poisson":
        return PoissonArrivals(nums[0])
    if kind == "bursty":
        kw = {}
        if len(nums) > 1:
            kw["burst"] = nums[1]
        if len(nums) > 2:
            kw["calm"] = nums[2]
        return BurstyArrivals(nums[0], **kw)
    if kind == "diurnal":
        kw = {}
        if len(nums) > 1:
            kw["period_s"] = nums[1]
        if len(nums) > 2:
            kw["depth"] = nums[2]
        return DiurnalArrivals(nums[0], **kw)
    raise ValueError(f"unknown arrival process {kind!r}; want "
                     "burst | poisson:R | bursty:R[:B[:C]] | "
                     "diurnal:R[:P[:D]]")


# ---------------------------------------------------------------------------
# request mixes and tenants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RequestMix:
    """Lognormal-ish prompt/decode length distributions, clipped to the
    engine's window.  ``median`` values are the distribution medians;
    ``sigma`` the log-space spread."""

    prompt_median: float
    decode_median: float
    sigma: float = 0.45
    prompt_min: int = 2
    decode_min: int = 2

    def draw(self, rng: np.random.Generator,
             max_len: int) -> Tuple[int, int]:
        p = int(round(self.prompt_median *
                      math.exp(self.sigma * rng.standard_normal())))
        d = int(round(self.decode_median *
                      math.exp(self.sigma * rng.standard_normal())))
        # prompt must leave decode room inside the window; both floors
        # keep degenerate draws servable
        p = max(self.prompt_min, min(p, max_len - 1 - self.decode_min))
        d = max(self.decode_min, min(d, max_len - 1 - p))
        return p, d


def mix_for_arch(arch_id: str, max_len: int) -> RequestMix:
    """A traffic shape characteristic of the arch's family in the
    ``configs/`` zoo: recurrent/ssm archs serve decode-heavy streams,
    VLMs prompt-heavy multimodal fills, MoEs long balanced chats, dense
    the interactive middle."""
    cfg = get_config(arch_id)
    scale = max_len / 256.0
    fam = cfg.family
    if fam in ("ssm", "hybrid"):            # long generation streams
        return RequestMix(prompt_median=12 * scale,
                          decode_median=56 * scale)
    if fam in ("vlm", "audio"):             # big multimodal prefills
        return RequestMix(prompt_median=96 * scale,
                          decode_median=12 * scale)
    if fam == "moe":                        # long balanced chats
        return RequestMix(prompt_median=48 * scale,
                          decode_median=36 * scale, sigma=0.6)
    return RequestMix(prompt_median=24 * scale,    # dense interactive
                      decode_median=20 * scale)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    arch: str                       # zoo arch shaping this tenant's mix
    mix: RequestMix
    weight: float = 1.0             # share of arrivals
    priority: int = 0               # higher admits first
    quota_tokens: Optional[int] = None   # in-flight token cap
    slo_ttft_s: Optional[float] = None   # per-tenant TTFT deadline
    # shared-prefix traffic: a fraction ``share_ratio``
    # of this tenant's requests open with the tenant's fixed
    # ``system_prompt_len``-token system prompt; the engine dedups
    # those requests' KV pages against one shared base
    system_prompt_len: int = 0
    share_ratio: float = 0.0


def default_tenants(n: int, max_len: int,
                    quota_tokens: Optional[int] = None,
                    slo_ttft_s: Optional[float] = None,
                    system_prompt_len: int = 0,
                    share_ratio: float = 0.0
                    ) -> List[TenantSpec]:
    """N tenants round-robin over the zoo, tiered priorities: tenant 0
    is the paying interactive class (highest priority), later tenants
    progressively batch-ier."""
    out = []
    for i in range(n):
        arch = ARCHS[i % len(ARCHS)]
        out.append(TenantSpec(
            name=f"tenant{i}", arch=arch,
            mix=mix_for_arch(arch, max_len),
            weight=1.0,
            priority=max(0, n - 1 - i),
            quota_tokens=quota_tokens,
            slo_ttft_s=slo_ttft_s,
            system_prompt_len=system_prompt_len,
            share_ratio=share_ratio))
    return out


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One scheduled request, before materialisation: everything needed
    to build the ``Request`` deterministically."""

    t: float
    rid: int
    tenant: str
    priority: int
    prompt_len: int
    max_new: int
    deadline_s: Optional[float]
    prefix_len: int = 0         # leading tokens from the tenant's
    #                             fixed system prompt (0 = unshared)


class Workload:
    """Deterministic open-loop schedule: arrival process × tenant mix.

    ``schedule(n)`` draws the full event list up front (arrival times
    from the process stream, tenant assignment and request shapes from
    per-tenant streams), so the same seed gives the same schedule no
    matter how the fleet consumes it.  ``requests()`` materialises
    ``Request`` objects with seeded prompt tokens.
    """

    def __init__(self, arrivals: ArrivalProcess,
                 tenants: Sequence[TenantSpec], max_len: int,
                 seed: int = 0):
        if not tenants:
            raise ValueError("need at least one tenant")
        self.arrivals = arrivals
        self.tenants = list(tenants)
        self.max_len = max_len
        self.seed = seed

    def schedule(self, n_requests: int) -> List[ArrivalEvent]:
        rng_t = _stream(self.seed, f"arrivals:{self.arrivals.describe()}")
        times = self.arrivals.times(n_requests, rng_t)
        w = np.asarray([t.weight for t in self.tenants], np.float64)
        w = w / w.sum()
        rng_assign = _stream(self.seed, "tenant-assign")
        picks = rng_assign.choice(len(self.tenants), size=n_requests, p=w)
        shape_rngs = [_stream(self.seed, f"shape:{t.name}")
                      for t in self.tenants]
        # share decisions draw from NEW per-tenant streams, so turning
        # sharing off (the default) leaves every legacy stream — and the
        # whole schedule — byte-identical
        share_rngs = [_stream(self.seed, f"share:{t.name}")
                      for t in self.tenants]
        events = []
        for rid, (t, k) in enumerate(zip(times, picks)):
            ten = self.tenants[k]
            p, d = ten.mix.draw(shape_rngs[k], self.max_len)
            pfx = 0
            if ten.system_prompt_len > 0 and ten.share_ratio > 0.0 and \
                    share_rngs[k].random() < ten.share_ratio:
                pfx = min(ten.system_prompt_len, p)
            events.append(ArrivalEvent(
                t=float(t), rid=rid, tenant=ten.name,
                priority=ten.priority, prompt_len=p, max_new=d,
                deadline_s=ten.slo_ttft_s, prefix_len=pfx))
        return events

    def requests(self, events: Sequence[ArrivalEvent],
                 vocab: int) -> List[Tuple[float, Request]]:
        """Materialise (arrival_time, Request) pairs; prompt tokens come
        from one per-workload stream so rid k's prompt is stable even if
        the event list is filtered or re-ordered upstream."""
        rng = _stream(self.seed, "prompts")
        sys_prompts = {}
        out = []
        for ev in events:
            prompt = rng.integers(0, vocab, size=ev.prompt_len,
                                  dtype=np.int32)
            if ev.prefix_len > 0:
                # overwrite the head with the tenant's fixed system
                # prompt (its own stream, drawn once per tenant): the
                # tail stays rid-stable, prompt length is unchanged,
                # and prefix_len=0 events are untouched bytes
                sp = sys_prompts.get(ev.tenant)
                if sp is None:
                    sp = _stream(self.seed, f"sysprompt:{ev.tenant}") \
                        .integers(0, vocab, size=self.max_len,
                                  dtype=np.int32)
                    sys_prompts[ev.tenant] = sp
                prompt[:ev.prefix_len] = sp[:ev.prefix_len]
            req = Request(rid=ev.rid, prompt=prompt, max_new=ev.max_new,
                          tenant=ev.tenant, priority=ev.priority,
                          deadline_s=ev.deadline_s, t_arrival=ev.t,
                          prefix_len=ev.prefix_len)
            out.append((ev.t, req))
        return out
