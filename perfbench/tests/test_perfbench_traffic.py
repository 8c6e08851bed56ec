"""Every seed serves the same sizes in another order; a seed repeats."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"
LONGDOC = json.loads((MIXES / "longdoc.json").read_text())


def _sizes(stream, k):
    return [(len(d.prompt), d.answer) for d in (stream.next() for _ in
                                                range(k))]


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 3 * 2 ** 31 + 8, 7])
def test_each_pass_serves_the_pool_in_the_seeds_order(seed):
    mix = LONGDOC
    n = mix["pool"]
    prompts, answers = traffic.pool(mix)
    s = traffic.Stream(mix, seed, 1000)
    for _ in range(3):
        got = _sizes(s, n)
        assert sorted(p for p, _ in got) == sorted(prompts)
        assert sorted(a for _, a in got) == sorted(answers)
    again = traffic.Stream(mix, seed, 1000)
    first = [again.next() for _ in range(n)]
    s = traffic.Stream(mix, seed, 1000)
    assert all(np.array_equal(x.prompt, s.next().prompt) for x in first)


def test_seeds_differ_in_order_and_pairing():
    n = LONGDOC["pool"]
    a = _sizes(traffic.Stream(LONGDOC, 2 ** 31 + 11, 1000), 2 * n)
    b = _sizes(traffic.Stream(LONGDOC, 3 * 2 ** 31 + 8, 1000), 2 * n)
    assert a != b
    assert sorted(a) != sorted(b)           # another pairing, too
    # and the order is no rotation of one fixed cycle
    assert not any(b[:n] == a[k:n] + a[:k] for k in range(n))


def test_pool_sits_in_the_mix():
    mix = LONGDOC
    prompts, answers = traffic.pool(mix)
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= p <= hi for p in prompts)
    assert max(prompts) + max(answers) <= mix["max_len"]
    assert float(np.median(prompts)) == pytest.approx(
        mix["prompt"]["median"], rel=0.05)
    assert mix["answer"]["min"] <= min(answers) <= max(answers) \
        <= mix["answer"]["max"]
    s = traffic.Stream(mix, 5, 1000)
    assert len(s.longest().prompt) == max(prompts) and s.longest().answer == 2


def test_staggered_answers():
    d = traffic.Draw(np.zeros(5, np.int32), 64)
    assert [traffic.staggered(d, c, 8, 64).answer for c in range(8)] == \
        [8, 16, 24, 32, 40, 48, 56, 64]
    assert [traffic.staggered(d, c, 8, 16).answer for c in range(8)] == \
        [2, 4, 6, 8, 10, 12, 14, 16]
    assert traffic.staggered(traffic.Draw(d.prompt, 3), 0, 8, 64).answer == 2
