"""The traffic generator: one closed loop, its mix read from
``traffic/<mix>.json``.

Every seed serves the same set of request sizes in its own order.  The
set is a pool of ``pool`` prompt lengths at the quantiles of the mix's
lognormal (median and sigma, clipped to its range) and ``pool`` answer
lengths at the quantiles of theirs.  The stream goes through the pool
pass after pass; each pass serves every prompt length and every answer
length once, in an order and a pairing drawn from the seed.  So a seed
changes which requests meet in one step, as users' requests do, and
not the work the window holds: a pool drawn afresh from the
distribution would let one seed serve its short half and another its
long half.  The seed also draws the prompts' token ids; a seed repeats
exactly.  The lognormal is the one of
``repro_torch.serving.workload.RequestMix`` (median times exp of sigma
times a standard normal), taken at quantiles instead of drawn.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def _quantile_lengths(dist: dict, n: int) -> List[int]:
    lo, hi = int(dist["min"]), int(dist["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            x = float(dist["median"]) * math.exp(float(dist["sigma"]) * z)
        elif dist["dist"] == "uniform":
            x = lo + (hi - lo) * u
        else:
            raise ValueError(f"unknown length distribution {dist['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def pool(mix: dict) -> Tuple[List[int], List[int]]:
    """The mix's prompt and answer lengths, the same for every seed."""
    n = int(mix["pool"])
    prompts = _quantile_lengths(mix["prompt"], n)
    answers = _quantile_lengths(mix["answer"], n)
    if max(prompts) + max(answers) > int(mix["max_len"]):
        raise ValueError(f"a request of {max(prompts)} + {max(answers)} "
                         f"tokens overruns max_len {mix['max_len']}")
    return prompts, answers


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclass
class Draw:
    prompt: np.ndarray          # (P,) int32 token ids
    answer: int                 # tokens to serve


class Stream:
    """The seed's endless sequence of requests over the mix's pool."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.prompts, self.answers = pool(mix)
        self.vocab = int(vocab)
        self._order = _rng(seed, 1)
        self._pass: List[Tuple[int, int]] = []
        self._tokens = _rng(seed, 2)

    def _next_pair(self) -> Tuple[int, int]:
        if not self._pass:
            n = len(self.prompts)
            pi, ai = self._order.permutation(n), self._order.permutation(n)
            self._pass = [(self.prompts[int(i)], self.answers[int(j)])
                          for i, j in zip(pi, ai)][::-1]
        return self._pass.pop()

    def _tokens_of(self, n: int) -> np.ndarray:
        return self._tokens.integers(0, self.vocab, n, dtype=np.int64) \
            .astype(np.int32)

    def next(self) -> Draw:
        p, a = self._next_pair()
        return Draw(self._tokens_of(p), a)

    def longest(self) -> Draw:
        """A request of the pool's longest prompt, with a 2-token
        answer: the set-up's first request, which grows the allocator to
        the largest prefill the window will see."""
        return Draw(self._tokens_of(max(self.prompts)), 2)


def staggered(draw: Draw, client: int, clients: int, cap: int) -> Draw:
    """A client's set-up request: its answer, at most ``cap``, cut to
    ``(client + 1) / clients``, so that the slots finish their first
    request at spread steps and the window opens on staggered slots."""
    a = min(draw.answer, cap) * (client + 1) / clients
    return Draw(draw.prompt, max(2, int(round(a))))
