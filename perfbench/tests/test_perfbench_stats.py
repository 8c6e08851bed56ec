"""Percentiles over every sample, a stalled step kept in the tail, and a
failed request counted as missing."""
import math

import pytest

from perfbench import harness
from perfbench import yardstick as Y


def test_nearest_rank_over_every_sample():
    v = list(range(1, 101))
    assert Y.percentile(v, 95) == 95
    assert Y.percentile(v, 90) == 90
    assert Y.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        Y.percentile([], 50)


def test_a_stall_on_every_slot_shows_in_the_tail():
    # 8 slots, 100 steps of 50 ms, one admission step of 600 ms that
    # every decoding slot waits through: 8 of 808 gaps, under 5%
    gaps = [0.05] * 800 + [0.6] * 8
    assert Y.percentile(gaps, 95) == 0.05
    # admissions in 6% of the steps: the 95th gap is a stall, where a
    # median of per-step or per-request means would hide it
    gaps = [0.05] * 752 + [0.6] * 48
    assert Y.percentile(gaps, 95) == 0.6
    per_request_means = [(0.05 * 94 + 0.6 * 6) / 100] * 8
    assert Y.percentile(per_request_means, 95) < 0.1


def test_failed_request_counts_as_missing():
    run = harness.RunView(spec={}, mix={}, ttft_s=[0.1] * 5 + [math.inf] * 5)
    mod = harness.load_reader("ttft_p50_ms")
    assert mod.read(run) == pytest.approx(100.0)
    run.ttft_s = [0.1] * 4 + [math.inf] * 6
    assert math.isinf(mod.read(run))


def test_rates_and_gaps_read_every_token():
    run = harness.RunView(spec={}, mix={}, window_s=2.0, tokens=300,
                          gaps_s=[0.01] * 19 + [1.0])
    assert harness.load_reader("output_tok_s").read(run) == 150.0
    assert harness.load_reader("itl_p95_ms").read(run) == pytest.approx(10.0)
    run.gaps_s = [0.01] * 18 + [1.0] * 2
    assert harness.load_reader("itl_p95_ms").read(run) == pytest.approx(1e3)
