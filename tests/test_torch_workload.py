"""The port's open-loop workload against the reference's: the same seed,
arrival spec and tenants give bit-identical schedules (``ArrivalEvent``
lists) and prompt bytes, share streams included; ``parse_arrivals``
refuses the same specs with the same messages; ``default_tenants`` and
``mix_for_arch`` agree over the whole config zoo."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.serving import workload as ref  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.serving import workload as port  # noqa: E402

SPECS = ["burst", "poisson:8", "poisson:100", "bursty:8", "bursty:8:5:0.2",
         "diurnal:8", "diurnal:8:4:0.5"]


def _events(mod, spec, seed, n_tenants, max_len, n, share):
    tenants = mod.default_tenants(
        n_tenants, max_len, quota_tokens=96, slo_ttft_s=0.25,
        system_prompt_len=16 if share else 0,
        share_ratio=0.5 if share else 0.0)
    wl = mod.Workload(mod.parse_arrivals(spec), tenants, max_len,
                      seed=seed)
    events = wl.schedule(n)
    return events, wl.requests(events, vocab=1000)


@pytest.mark.parametrize("share", [False, True], ids=["plain", "share"])
@pytest.mark.parametrize("n_tenants", [1, 3])
@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_and_prompts_are_bit_identical(spec, seed, n_tenants,
                                                share):
    want_ev, want_req = _events(ref, spec, seed, n_tenants, 128, 24, share)
    got_ev, got_req = _events(port, spec, seed, n_tenants, 128, 24, share)
    assert [dataclasses.asdict(e) for e in got_ev] == \
        [dataclasses.asdict(e) for e in want_ev]
    assert len(got_req) == len(want_req) == 24
    for (gt, g), (wt, w) in zip(got_req, want_req):
        assert gt == wt == g.t_arrival == w.t_arrival
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        assert g.prompt.tobytes() == w.prompt.tobytes()
        for f in ("rid", "max_new", "tenant", "priority", "deadline_s",
                  "prefix_len"):
            assert getattr(g, f) == getattr(w, f), f
        assert g.cost_tokens() == w.cost_tokens()
    if share and spec != "burst":
        # the share streams drew: some requests open with the prompt
        assert any(e.prefix_len for e in got_ev)


@pytest.mark.parametrize("spec", SPECS[1:])
def test_arrival_times_follow_the_reference_stream(spec):
    rng_r = np.random.default_rng(3)
    rng_p = np.random.default_rng(3)
    want = ref.parse_arrivals(spec).times(200, rng_r)
    got = port.parse_arrivals(spec).times(200, rng_p)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.all(np.diff(got) >= 0)
    assert port.parse_arrivals(spec).describe() == \
        ref.parse_arrivals(spec).describe()


@pytest.mark.parametrize("spec", [
    "poisson", "poisson:x", "burst:3", "zipf:4", "poisson:0",
    "bursty:8:1", "bursty:8:4:5", "diurnal:8:4:1.5", "diurnal:8:0",
    "diurnal:-1",
])
def test_parse_arrivals_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as want:
        ref.parse_arrivals(spec)
    with pytest.raises(ValueError) as got:
        port.parse_arrivals(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("max_len", [64, 128, 2304])
def test_tenants_and_mixes_over_the_zoo(max_len):
    assert tuple(ARCHS) == tuple(REF_ARCHS)
    for arch in ARCHS:
        assert dataclasses.asdict(port.mix_for_arch(arch, max_len)) == \
            dataclasses.asdict(ref.mix_for_arch(arch, max_len)), arch
    n = len(ARCHS) + 2                 # wraps round the zoo
    got = port.default_tenants(n, max_len, quota_tokens=64,
                               slo_ttft_s=0.5, system_prompt_len=8,
                               share_ratio=0.25)
    want = ref.default_tenants(n, max_len, quota_tokens=64,
                               slo_ttft_s=0.5, system_prompt_len=8,
                               share_ratio=0.25)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    assert [t.priority for t in got] == list(range(n - 1, -1, -1))


def test_mix_draws_stay_inside_the_window():
    mix = port.mix_for_arch("qwen2-0.5b", 32)
    rng = np.random.default_rng(0)
    for _ in range(500):
        p, d = mix.draw(rng, 32)
        assert p >= mix.prompt_min and d >= mix.decode_min
        assert p + d <= 31


def test_workload_needs_a_tenant():
    with pytest.raises(ValueError, match="at least one tenant"):
        port.Workload(port.BurstArrivals(), [], 64)
