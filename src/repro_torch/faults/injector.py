"""Deterministic, seedable fault injection for the memory plane (§9).

One module-level plan, gated exactly like ``repro_torch.obs``: call sites
check the module attribute ``ACTIVE`` (a plain bool read + branch —
zero overhead, no lock, no call) and only reach the injection logic
when a plan is installed.  With no plan installed every hook compiles
down to a dead branch and the fault-free benchmarks are bit-identical.

The plan draws every fault from per-scope ``random.Random`` streams
seeded by ``crc32(f"{seed}:{scope}")``, so a given (seed, topology)
replays the exact same fault schedule run after run — the property the
chaos bench gates on.  A *scope* is where the op executes: each
``MemoryNode`` gets a unique ``fault_scope`` (``memnode0#3``), host
DMA paths use ``xdma``/``qdma``, completion delivery uses ``cq``.

Fault kinds (all per-op probability or scheduled window):

* transient ``WCStatus`` errors → ``TransientCompletionError``
* completion timeouts → ``InjectedTimeout`` (a ``CompletionTimeout``)
* payload bit-flips → ``corrupt()`` flips one deterministic bit
* node flap → ops inside a ``[lo, hi)`` op-count window raise
  ``NodeUnavailable`` (down), then the node serves again (up)
* straggler latency → deterministic extra sleep before the op
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.faults.retry import (InjectedTimeout, NodeUnavailable,
                                TransientCompletionError)

#: module-level gate, mirrors ``obs.metrics._LIVE``: hooks check
#: ``injector.ACTIVE`` (attribute read) before touching the plan.
ACTIVE: bool = False
_PLAN: Optional["FaultPlan"] = None
_LOCK = threading.Lock()


class _ScopeState:
    """Per-scope deterministic RNG stream + op counter."""

    __slots__ = ("rng", "ops")

    def __init__(self, seed: int, scope: str):
        import random
        self.rng = random.Random(zlib.crc32(f"{seed}:{scope}".encode()))
        self.ops = 0


class FaultPlan:
    """A seeded schedule of faults for one run.

    Probabilities are per-op draws from the scope's stream; ``flaps``
    schedules deterministic down-windows keyed by scope substring
    (``{"memnode0#2": [(40, 80)]}`` → ops 40..79 on that node raise
    ``NodeUnavailable``).  ``only_scopes`` restricts injection to
    scopes containing any of the given substrings (empty = all).
    """

    def __init__(self, seed: int = 0, *,
                 error_rate: float = 0.0,
                 timeout_rate: float = 0.0,
                 corrupt_rate: float = 0.0,
                 max_corruptions: int = 1,
                 straggler_rate: float = 0.0,
                 straggler_s: float = 0.002,
                 flaps: Optional[Dict[str, List[Tuple[int, int]]]] = None,
                 only_scopes: Optional[List[str]] = None):
        for name, rate in (("error_rate", error_rate),
                           ("timeout_rate", timeout_rate),
                           ("corrupt_rate", corrupt_rate),
                           ("straggler_rate", straggler_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.seed = seed
        self.error_rate = error_rate
        self.timeout_rate = timeout_rate
        self.corrupt_rate = corrupt_rate
        self.max_corruptions = max_corruptions
        self.straggler_rate = straggler_rate
        self.straggler_s = straggler_s
        self.flaps = dict(flaps or {})
        self.only_scopes = list(only_scopes or [])
        self._lock = threading.Lock()
        self._scopes: Dict[str, _ScopeState] = {}
        self.counters: Dict[str, int] = {
            "errors": 0, "timeouts": 0, "corruptions": 0,
            "straggles": 0, "flap_rejections": 0,
        }

    # -- internals -------------------------------------------------------
    def _skip(self, scope: str) -> bool:
        return bool(self.only_scopes) and not any(
            s in scope for s in self.only_scopes)

    def _state(self, scope: str) -> _ScopeState:
        st = self._scopes.get(scope)
        if st is None:
            st = self._scopes[scope] = _ScopeState(self.seed, scope)
        return st

    def _flapped(self, scope: str, op_idx: int) -> bool:
        for key, windows in self.flaps.items():
            if key in scope:
                for lo, hi in windows:
                    if lo <= op_idx < hi:
                        return True
        return False

    def _bump(self, key: str) -> None:
        self.counters[key] = self.counters[key] + 1

    # -- hooks (call sites gate on injector.ACTIVE first) ----------------
    def before_op(self, scope: str) -> None:
        """Draw faults for one op about to execute in ``scope``.

        May sleep (straggler) and/or raise a typed transient error.
        The op counter advances on every call, faulted or not, so flap
        windows are positions in the node's op sequence regardless of
        how many draws hit.
        """
        if self._skip(scope):
            return
        with self._lock:
            st = self._state(scope)
            idx = st.ops
            st.ops += 1
            if self._flapped(scope, idx):
                self._bump("flap_rejections")
                raise NodeUnavailable(f"{scope}: down (injected flap, "
                                      f"op {idx})")
            straggle = (self.straggler_rate > 0.0 and
                        st.rng.random() < self.straggler_rate)
            err = (self.error_rate > 0.0 and
                   st.rng.random() < self.error_rate)
            tmo = (self.timeout_rate > 0.0 and
                   st.rng.random() < self.timeout_rate)
            if straggle:
                self._bump("straggles")
            if err:
                self._bump("errors")
            elif tmo:
                self._bump("timeouts")
        # sleep outside the lock so concurrent scopes don't serialize
        if straggle:
            time.sleep(self.straggler_s)
        if err:
            raise TransientCompletionError(
                f"{scope}: injected completion error (op {idx})")
        if tmo:
            raise InjectedTimeout(
                f"{scope}: injected completion timeout (op {idx})")

    def delay(self, scope: str) -> None:
        """Straggler-only draw — the completion-delivery hook (verbs CQ):
        delivery can lag, but a CQ never *fails* an already-executed WR."""
        if self.straggler_rate <= 0.0 or self._skip(scope):
            return
        with self._lock:
            st = self._state(scope)
            st.ops += 1
            straggle = st.rng.random() < self.straggler_rate
            if straggle:
                self._bump("straggles")
        if straggle:
            time.sleep(self.straggler_s)

    def corrupt(self, scope: str, buf) -> bool:
        """Maybe flip one deterministic bit of ``buf`` (a writable
        uint8 view of a just-transferred payload).  Returns True when a
        flip happened.  Capped by ``max_corruptions`` per run."""
        if self.corrupt_rate <= 0.0 or self._skip(scope):
            return False
        with self._lock:
            if self.counters["corruptions"] >= self.max_corruptions:
                return False
            st = self._state(scope)
            if st.rng.random() >= self.corrupt_rate or len(buf) == 0:
                return False
            byte = st.rng.randrange(len(buf))
            bit = st.rng.randrange(8)
            self._bump("corruptions")
        buf[byte] ^= 1 << bit
        return True

    def snapshot(self) -> dict:
        with self._lock:
            return {"seed": self.seed, **self.counters}


# -- module API ----------------------------------------------------------
def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide and open the ACTIVE gate."""
    global ACTIVE, _PLAN
    with _LOCK:
        _PLAN = plan
        ACTIVE = True
    return plan


def uninstall() -> Optional[FaultPlan]:
    """Close the gate; returns the previous plan (for its counters)."""
    global ACTIVE, _PLAN
    with _LOCK:
        plan, _PLAN = _PLAN, None
        ACTIVE = False
    return plan


def active() -> bool:
    return ACTIVE


def current() -> Optional[FaultPlan]:
    return _PLAN
