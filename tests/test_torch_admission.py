"""The port's admission controller against the reference's: the same
scripted ``enqueue`` / ``observe_step`` / ``observe_finish`` / ``select``
sequence gives the same admits, sheds (with their reasons) and
``stats()``; the engine-level quota and SLO behaviour mirrors
``tests/test_serving.py``; ``kv_free_pages`` reads the engine's own page
range over a shared plane; ``kv_capacity_bytes`` is a hard budget under
the controller."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import AdmissionController as RefController  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch.access import create_path  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (AdmissionController, Request,  # noqa: E402
                                 ServeEngine, failure_kind)
from repro_torch.serving.engine import page_bytes_for  # noqa: E402


def _pair(rid, prompt_len=6, max_new=6, tenant="default", priority=0,
          deadline_s=None, prefix_len=0):
    prompt = np.random.default_rng(rid).integers(0, 256, prompt_len,
                                                 dtype=np.int32)
    kw = dict(rid=rid, max_new=max_new, tenant=tenant, priority=priority,
              deadline_s=deadline_s, prefix_len=prefix_len)
    return (RefRequest(prompt=prompt.copy(), **kw),
            Request(prompt=prompt.copy(), **kw))


def _kv_cost(req):
    return 0.5 if req.prefix_len else 1.0


# each op: ("enq", request kwargs) | ("step", dt, active) |
# ("finish", rid, n_tokens) | ("select", free, kv_free, slots, kv_cost?)
SCRIPTS = {
    "fifo": [("enq", dict(rid=i)) for i in range(5)] + [
        ("select", 2, 2, 2, False), ("step", 0.5, 2), ("step", 0.01, 2),
        ("finish", 0, 6), ("select", 1, 1, 2, False),
        ("select", 4, 4, 2, False)],
    "priority": [
        ("enq", dict(rid=0, priority=0)), ("enq", dict(rid=1, priority=2)),
        ("enq", dict(rid=2, priority=1)), ("enq", dict(rid=3, priority=2)),
        ("select", 1, 1, 1, False), ("select", 2, 2, 2, False),
        ("select", 2, 1, 2, False)],
    "quota": [
        ("enq", dict(rid=0, tenant="a")), ("enq", dict(rid=1, tenant="a")),
        ("enq", dict(rid=2, tenant="a", max_new=20)),
        ("enq", dict(rid=3, tenant="b")),
        ("select", 4, 4, 4, False), ("finish", 0, 6),
        ("select", 4, 4, 4, False), ("finish", 1, 6), ("finish", 3, 6)],
    "slo": [("enq", dict(rid=i, deadline_s=None if i % 3 else 0.05))
            for i in range(8)] + [
        ("select", 2, 2, 2, False), ("step", 1.0, 2), ("step", 0.02, 2),
        ("step", 0.03, 2), ("finish", 0, 6), ("finish", 1, 6),
        ("enq", dict(rid=8, deadline_s=10.0)),
        ("select", 2, 2, 2, False), ("step", 0.02, 1), ("step", 0.0, 0),
        ("select", 2, 2, 2, False), ("select", 4, 4, 4, False)],
    "kv_cost": [("enq", dict(rid=i, prefix_len=4 if i % 2 else 0))
                for i in range(8)] + [
        ("select", 8, 3, 8, True), ("select", 8, 2, 8, True),
        ("select", 8, 0, 8, True), ("select", 8, 5, 8, True)],
}


@pytest.mark.parametrize("policy", [
    dict(), dict(default_quota=12), dict(slo_ttft_s=0.08),
    dict(quotas={"a": 12}, default_quota=30, slo_ttft_s=0.2)],
    ids=["none", "quota", "slo", "mixed"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_decisions_match_reference(script, policy):
    ctl = {"ref": RefController(**policy), "port": AdmissionController(
        **policy)}
    reqs = {"ref": {}, "port": {}}
    log = {"ref": [], "port": []}
    for op in SCRIPTS[script]:
        for side in ("ref", "port"):
            c = ctl[side]
            if op[0] == "enq":
                pair = _pair(**op[1])
                r = pair[0] if side == "ref" else pair[1]
                reqs[side][r.rid] = r
                c.enqueue(r)
            elif op[0] == "step":
                c.observe_step(op[1], active=op[2])
            elif op[0] == "finish":
                r = reqs[side][op[1]]
                r.out_tokens = [1] * op[2]
                c.observe_finish(r)
            else:
                _, free, kv_free, slots, cost = op
                admits, sheds = c.select(
                    free_slots=free, kv_free=kv_free, batch_slots=slots,
                    kv_cost=_kv_cost if cost else None)
                log[side].append(([r.rid for r in admits],
                                  [(r.rid, why) for r, why in sheds],
                                  [r.rid for r in c.backlog]))
    assert log["port"] == log["ref"]
    assert ctl["port"].stats() == ctl["ref"].stats()
    assert ctl["port"].inflight == ctl["ref"].inflight


def test_first_step_is_kept_out_of_the_cadence():
    c = AdmissionController()
    c.observe_step(5.0, active=1)
    assert c.cadence_s is None and c.vt == 5.0
    c.observe_step(0.1, active=1)
    c.observe_step(0.2, active=1)
    assert c.cadence_s == pytest.approx(0.7 * 0.1 + 0.3 * 0.2)
    c.observe_step(9.0, active=0)        # idle steps move only the clock
    assert c.cadence_s == pytest.approx(0.13) and c.vt == pytest.approx(14.3)


def test_drain_backlog_hands_everything_back():
    c = AdmissionController()
    for i in range(3):
        c.enqueue(_pair(i)[1])
    out = c.drain_backlog()
    assert [r.rid for r in out] == [0, 1, 2] and c.backlog == []
    assert c.select(4, 4, 4) == ([], [])


def test_failure_kinds_of_the_policy_reasons():
    assert failure_kind("slo: predicted TTFT 1.000s > deadline 0.1s") == \
        "slo"
    assert failure_kind("quota: request cost 30 tokens exceeds tenant "
                        "quota 12") == "quota"
    assert failure_kind("prompt length 70 >= engine max_len 64") == \
        "overlong"


# ---------------------------------------------------------------------------
# the engine under a controller (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    return cfg, T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")


def _req(rid, vocab, prompt_len=6, max_new=6, **kw):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, prompt=rng.integers(0, vocab, prompt_len,
                                                dtype=np.int32),
                   max_new=max_new, **kw)


def test_engine_quota_enforced_end_to_end(model):
    cfg, params = model
    quota = 6 + 5                 # exactly one request in flight
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                      admission=AdmissionController(default_quota=quota),
                      device="cpu")
    for i in range(4):
        eng.submit(_req(i, cfg.vocab, max_new=5))
    assert eng.run_until_drained() == 0
    served = [r for r in eng.done if r.failed is None]
    assert len(served) == 4
    assert all(len(r.out_tokens) == 5 for r in served)
    assert eng.admission.peak_inflight["default"] <= quota
    assert eng.outstanding_tokens() == 0 and eng.backlog_size() == 0


def test_engine_slo_sheds_under_saturation(model):
    """A saturating burst with a tiny TTFT deadline: once the cadence is
    measured, deep-queue requests shed before burning a slot (``slo``,
    no tokens) and the admitted ones finish."""
    cfg, params = model
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                      admission=AdmissionController(slo_ttft_s=1e-6),
                      device="cpu")
    for i in range(10):
        eng.submit(_req(i, cfg.vocab))
    assert eng.run_until_drained() == 0
    served = [r for r in eng.done if r.failed is None]
    shed = [r for r in eng.done if r.failed is not None]
    assert served and shed, (len(served), len(shed))
    assert all(r.failed.startswith("slo") for r in shed)
    assert all(r.out_tokens == [] and r.t_first_pc == 0.0 for r in shed)
    assert all(len(r.out_tokens) == 6 for r in served)
    assert eng.admission.shed_slo == len(shed) == eng.shed_requests
    assert eng.outstanding_tokens() == 0


def test_engine_controller_rejects_overlong_at_the_door(model):
    cfg, params = model
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                      admission=AdmissionController(), device="cpu")
    eng.submit(_req(0, cfg.vocab, prompt_len=40))
    eng.submit(_req(1, cfg.vocab))
    assert eng.run_until_drained() == 0
    assert [failure_kind(r.failed) for r in eng.done
            if r.failed] == ["overlong"]
    assert eng.admission.admitted == 1


def test_kv_free_pages_reads_the_engine_page_range(model):
    """Over a shared plane an engine's slot s is page ``page_base + s``:
    a resident or in-flight page of the OTHER replica's range does not
    take this engine's capacity, its own does."""
    cfg, params = model
    pb = page_bytes_for(cfg, 32)
    shared = create_path("xdma", n_pages=4, page_bytes=pb, n_channels=2,
                         device="cpu")
    engs = [ServeEngine(cfg, params, batch_slots=2, max_len=32,
                        shared_path=shared, page_base=2 * i,
                        total_pages=4, name=f"replica{i}", device="cpu")
            for i in range(2)]
    e0, e1 = engs
    assert [e._pg(s) for e in engs for s in range(2)] == [0, 1, 2, 3]
    assert e0.kv_free_pages() == e1.kv_free_pages() == 2
    page = np.zeros(pb, np.uint8)
    e1.pager.write_page(3, page)
    e1.pager.prefetch([3])              # replica1's slot 1 mid-fetch
    assert e1.kv_free_pages() == 1 and e0.kv_free_pages() == 2
    e0.pager.write_page(0, page)
    e0.pager.ensure([0])                # replica0's slot 0 resident
    assert e0.kv_free_pages() == 1 and e1.kv_free_pages() == 1
    for e in engs:
        e.close()
    assert not shared._closed           # the engines leave it open
    shared.close()


def test_capacity_bytes_is_a_hard_budget_under_the_controller(model):
    """Two slots but a one-page physical budget: with a controller the
    engine never holds more than one page (one request active at a
    time); it still serves every request."""
    cfg, params = model
    cap = page_bytes_for(cfg, 32)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                      access_path="xdma", kv_capacity_bytes=cap,
                      admission=AdmissionController(), device="cpu")
    for i in range(4):
        eng.submit(_req(i, cfg.vocab, max_new=4))
    peak = 0
    for _ in range(400):
        active = eng.step()
        peak = max(peak, active + len(eng._pending_install))
        assert eng.pager.cold_bytes_physical <= cap
        if active == 0 and eng.idle():
            break
    assert peak == 1
    assert sum(1 for r in eng.done if r.failed is None) == 4
    eng.close()
