"""The port's fleet router against the reference's and against one
engine: the same submissions route to the same replicas; a replica kill
re-routes its whole pipeline and every request keeps the single-engine
tokens (and the reference fleet's); a shared single path and a shared
3-member fabric with a member kill serve the same tokens;
``build(replicas=1)`` is a pass-through; the drain budgets warn.  The
reference's float32 smoke params cross over through ``interop``."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as rs  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import serving as ps  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402

MAX_LEN = 64


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = RT.tree_init(RT.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, pcfg, params, pparams


def _workload(mod, n, seed=11, spec="burst", tenants=2):
    wl = mod.Workload(mod.parse_arrivals(spec),
                      mod.default_tenants(tenants, MAX_LEN), MAX_LEN,
                      seed=seed)
    return wl, wl.schedule(n)


def _tokens(done):
    return {r.rid: list(r.out_tokens) for r in done if r.failed is None}


def _single_engine(pcfg, pparams, n, seed=11):
    """One paged port engine with 2 slots over the same requests."""
    wl, events = _workload(ps, n, seed)
    eng = ps.ServeEngine(pcfg, pparams, batch_slots=2, max_len=MAX_LEN,
                         access_path="xdma", device="cpu")
    for _, req in wl.requests(events, pcfg.vocab):
        eng.submit(req)
    assert eng.run_until_drained() == 0
    eng.close()
    return _tokens(eng.done)


@pytest.fixture(scope="module")
def single_tokens(model):
    _, pcfg, _, pparams = model
    return _single_engine(pcfg, pparams, 6)


def test_routing_matches_reference(model):
    """Least-outstanding-work with tenant affinity: submissions between
    fleet rounds go to the same replicas in both packages (no paging, no
    SLO: the loads follow tokens, not timing)."""
    cfg, pcfg, params, pparams = model
    routers = {
        "ref": rs.FleetRouter.build(cfg, params, replicas=3,
                                    batch_slots=2, max_len=MAX_LEN,
                                    affinity_slack_tokens=16),
        "port": ps.FleetRouter.build(pcfg, pparams, replicas=3,
                                     batch_slots=2, max_len=MAX_LEN,
                                     affinity_slack_tokens=16,
                                     device="cpu")}
    names = {}
    for side, mod, vocab in (("ref", rs, cfg.vocab),
                             ("port", ps, pcfg.vocab)):
        wl, events = _workload(mod, 12, seed=3, tenants=3)
        pairs = wl.requests(events, vocab)
        fr = routers[side]
        seq = []
        for k, (_, req) in enumerate(pairs):
            seq.append(fr.submit(req))
            if k % 3 == 2:
                fr.step_round()
        assert fr.run_until_drained() == 0
        names[side] = (seq, {n: v["routed"] for n, v in
                             fr.stats()["per_replica"].items()},
                       _tokens(fr.done_requests()))
        fr.close()
    assert names["port"][0] == names["ref"][0]
    assert names["port"][1] == names["ref"][1]
    assert len(set(names["port"][0])) > 1
    assert names["port"][2] == names["ref"][2]


def test_kill_reroute_gives_single_engine_and_reference_tokens(
        model, single_tokens):
    """Kill one of two replicas over a shared xdma path at round 2 (a
    burst: every request is routed before round 1, so the kill finds the
    replica mid-flight): its queue, backlog, pending installs and active
    slots re-route, and every request keeps the single engine's tokens
    and the reference fleet's."""
    cfg, pcfg, params, pparams = model
    wl, events = _workload(rs, 6)
    ref = rs.FleetRouter.build(cfg, params, replicas=2, batch_slots=2,
                               max_len=MAX_LEN, access_path="xdma",
                               kill_replica_at=(2, "replica1"),
                               admission_factory=rs.AdmissionController)
    assert ref.run_open_loop(wl.requests(events, cfg.vocab)) == 0
    ref_out = _tokens(ref.done_requests())
    ref.close()

    pwl, pevents = _workload(ps, 6)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=2,
                              max_len=MAX_LEN, access_path="xdma",
                              kill_replica_at=(2, "replica1"),
                              admission_factory=ps.AdmissionController,
                              device="cpu")
    victim = fr.engines["replica1"]
    assert fr.run_open_loop(pwl.requests(pevents, pcfg.vocab)) == 0
    st = fr.stats()
    assert st["killed_replicas"] == ["replica1"] and st["live"] == \
        ["replica0"]
    assert st["rerouted"] > 0
    assert st["per_replica"]["replica1"]["live"] is False
    # the victim's in-flight fetches were joined and dropped
    assert not victim._pending_install and not victim.pager._prefetch
    assert all(r is None for r in victim.slot_req)
    out = _tokens(fr.done_requests())
    assert set(out) == set(range(6))
    assert out == single_tokens == ref_out
    shared = fr.shared_path
    fr.close()
    assert shared._closed


def test_shared_path_serves_single_engine_tokens(model, single_tokens):
    _, pcfg, _, pparams = model
    wl, events = _workload(ps, 6)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=2,
                              max_len=MAX_LEN, access_path="xdma",
                              admission_factory=ps.AdmissionController,
                              device="cpu")
    assert fr.fabric is None and fr.shared_path is not None
    assert fr.shared_path.n_pages == 4
    assert [e.page_base for e in fr.engines.values()] == [0, 2]
    assert all(e.pager.path is fr.shared_path for e in fr.engines.values())
    # one set of parameters: every replica holds the same tensors
    assert all(e.params is pparams for e in fr.engines.values())
    assert fr.run_open_loop(wl.requests(events, pcfg.vocab)) == 0
    st = fr.stats()
    assert all(v["routed"] > 0 for v in st["per_replica"].values())
    assert _tokens(fr.done_requests()) == single_tokens
    assert sum(e.install_fused for e in fr.engines.values()) == 6
    fr.close()


def test_shared_fabric_member_kill_serves_single_engine_tokens(
        model, single_tokens):
    """Two replicas over one 3-member, 2-replica fabric; the router
    kills a member at round 2 and repairs: nothing lost, the same
    tokens."""
    _, pcfg, _, pparams = model
    wl, events = _workload(ps, 6)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=2,
                              max_len=MAX_LEN, access_path="xdma",
                              kv_shards=3, kv_replicas=2, kv_kill_step=2,
                              admission_factory=ps.AdmissionController,
                              device="cpu")
    assert fr.fabric is fr.shared_path is not None
    assert fr.run_open_loop(wl.requests(events, pcfg.vocab)) == 0
    st = fr.stats()
    assert st["killed_member"] is not None and st["kill_round"] == 2
    assert fr.kill_repair["lost"] == 0
    assert fr.fabric.stats()["epoch"] >= 1
    assert any(ev["round"] == 2 for ev in fr.fabric_events)
    assert _tokens(fr.done_requests()) == single_tokens
    fr.close()


def test_build_one_replica_is_a_pass_through(model, single_tokens):
    _, pcfg, _, pparams = model
    wl, events = _workload(ps, 6)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=1, batch_slots=2,
                              max_len=MAX_LEN, access_path="xdma",
                              device="cpu")
    (eng,) = fr.engines.values()
    assert eng.name == "replica0" and fr.shared_path is None
    assert eng.pager is not None and eng.page_base == 0
    assert eng.admission is None
    assert fr.run_open_loop(wl.requests(events, pcfg.vocab)) == 0
    assert _tokens(fr.done_requests()) == single_tokens
    fr.close()


def test_build_refusals(model):
    _, pcfg, _, pparams = model
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        ps.FleetRouter.build(pcfg, pparams, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="survivor"):
        ps.FleetRouter.build(pcfg, pparams, replicas=1,
                             kill_replica_at=(1, "replica0"),
                             device="cpu")
    with pytest.raises(ValueError, match="lose pages"):
        ps.FleetRouter.build(pcfg, pparams, replicas=2, max_len=MAX_LEN,
                             access_path="xdma", kv_kill_step=2,
                             device="cpu")
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=1,
                              max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="not live"):
        fr.kill_replica("replica7")
    fr.kill_replica("replica1")
    with pytest.raises(ValueError, match="last live"):
        fr.kill_replica("replica0")
    fr.close()


def test_drain_budgets_warn_naming_both(model):
    _, pcfg, _, pparams = model
    wl, events = _workload(ps, 2)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=1,
                              max_len=MAX_LEN, device="cpu")
    for _, req in wl.requests(events, pcfg.vocab):
        fr.submit(req)
    with pytest.warns(RuntimeWarning, match="undrained") as rec:
        left = fr.run_until_drained(max_steps=10000, deadline_s=0.0)
    assert left == 2
    assert "max_steps=10000" in str(rec[0].message)
    assert "deadline_s=0.0" in str(rec[0].message)
    eng = fr.engines["replica0"]
    n = eng.undrained_count()
    assert n >= 1
    with pytest.warns(RuntimeWarning, match="undrained") as rec:
        assert eng.run_until_drained(deadline_s=0.0) == n
    assert "deadline_s=0.0" in str(rec[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fr.run_until_drained() == 0
    with pytest.warns(RuntimeWarning, match="2 never released"):
        assert fr.run_open_loop(wl.requests(events, pcfg.vocab),
                                max_steps=0) == 2
    fr.close()


def test_merged_histograms_cover_every_replica(model):
    _, pcfg, _, pparams = model
    wl, events = _workload(ps, 4)
    fr = ps.FleetRouter.build(pcfg, pparams, replicas=2, batch_slots=2,
                              max_len=MAX_LEN, device="cpu")
    assert fr.run_open_loop(wl.requests(events, pcfg.vocab)) == 0
    h = fr.merged_hist("ttft_hist")
    assert h.summary()["count"] == 4 == sum(
        e.ttft_hist.summary()["count"] for e in fr.engines.values())
    st = fr.stats()
    assert st["served"] == 4 and st["goodput_tok_per_vs"] > 0
    assert st["virtual_seconds"] > 0 and st["rounds"] > 0
    fr.close()
