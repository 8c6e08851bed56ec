"""The port's sharded memory plane against the reference's: placement
(``HashRing`` owners, ``plan_rebalance`` moves, drops and losses) equal
to the reference's exactly; the ``ShardedPath`` and ``FabricManager``
cases of ``tests/test_fabric.py`` run on both packages with the same
pages and the same op sequence, their deterministic counters and repair
plans compared; and the serve CLI's sharded kill run gives the
reference's tokens and result keys at every level."""
import dataclasses
import itertools
import re
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fabric as RF  # noqa: E402
from repro.access import create_path as ref_path  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.rmem import TieredStore as RefStore  # noqa: E402
from repro_torch import fabric as PF  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.access import create_path as port_path  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.rmem import TieredStore as PortStore  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402


def _vals(n_pages, page_bytes, seed=0):
    rng = np.random.default_rng(seed)
    return {p: rng.integers(0, 256, page_bytes, np.uint8).astype(np.uint8)
            for p in range(n_pages)}


# ---------------------------------------------------------------------------
# placement: pure arithmetic, equal to the reference's on every input
# ---------------------------------------------------------------------------

MEMBER_SETS = [["a", "b"], [f"m{i}" for i in range(4)],
               [f"xdma/s{i}" for i in range(5)],
               ["verbs/s0", "verbs/s1", "verbs/s2"]]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
@pytest.mark.parametrize("members", MEMBER_SETS,
                         ids=lambda m: f"{len(m)}members")
def test_hash_ring_owners_equal_reference(members, vnodes):
    for r in range(1, len(members) + 1):
        ref = RF.HashRing(members, replicas=r, vnodes=vnodes)
        port = PF.HashRing(members, replicas=r, vnodes=vnodes)
        assert port.members == ref.members
        for p in range(200):
            assert port.owners(p) == ref.owners(p), (r, p)
            assert port.primary(p) == ref.primary(p)
        shrunk = members[:-1] or members
        assert port.with_members(shrunk).owners(7) == \
            ref.with_members(shrunk).owners(7)


def _plan_tuple(plan):
    return (plan.old_members, plan.new_members,
            [(m.page, m.dst, m.srcs) for m in plan.moves],
            list(plan.drops), list(plan.lost), plan.total_pages,
            plan.stats())


@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("change", ["remove", "add", "remove_dead",
                                    "swap"])
@pytest.mark.parametrize("vnodes", [8, 64])
def test_plan_rebalance_equals_reference(replicas, change, vnodes):
    members = [f"m{i}" for i in range(4)]
    pages = range(96)
    if change == "remove":
        new, alive = members[:-1], members
    elif change == "add":
        new, alive = members + ["m4"], None
    elif change == "remove_dead":
        # the victim's bytes are unreachable: its pages either copy from
        # a surviving replica or are reported lost
        new, alive = members[1:], members[1:]
    else:
        new, alive = members[1:] + ["m9"], members[1:]
    plans = [mod.plan_rebalance(mod.HashRing(members, replicas=replicas,
                                             vnodes=vnodes),
                                new, pages, alive=alive)
             for mod in (RF, PF)]
    assert _plan_tuple(plans[1]) == _plan_tuple(plans[0])
    if change == "remove_dead" and replicas == 1:
        assert plans[1].lost          # unreplicated pages are lost


def test_hash_ring_validation_matches_reference():
    for bad in ([], ["a", "b"], ["a"]):
        for kw in ({}, {"replicas": 3}, {"replicas": 0}, {"vnodes": 0}):
            errs = []
            for mod in (RF, PF):
                try:
                    mod.HashRing(bad, **kw)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            assert errs[0] == errs[1], (bad, kw)


# ---------------------------------------------------------------------------
# ShardedPath and FabricManager: the reference's cases on both packages
# ---------------------------------------------------------------------------

def _both(shards=3, replicas=2, n_pages=8, page_bytes=64, member="xdma",
          **kw):
    ref = ref_path("fabric", member=member, shards=shards,
                   replicas=replicas, n_pages=n_pages,
                   page_bytes=page_bytes, n_channels=1, **kw)
    port = port_path("fabric", member=member, shards=shards,
                     replicas=replicas, n_pages=n_pages,
                     page_bytes=page_bytes, n_channels=1, device="cpu",
                     **kw)
    return ref, port


COUNTERS = ("bytes_stored", "store_ops", "replicated_writes",
            "written_pages", "epoch", "failed", "rebalances",
            "pages_moved", "integrity_failures", "degraded_writes",
            "under_replicated", "quorum_reads")


def _counters(fab):
    s = fab.stats()
    return {k: s[k] for k in COUNTERS}


@pytest.mark.parametrize("member", ["xdma", "qdma", "verbs"])
def test_replicated_writes_land_on_the_reference_members(member):
    ref, port = _both(member=member, doorbell_batch=2)
    with ref, port:
        v = _vals(8, 64)
        for fab in (ref, port):
            for p, val in v.items():
                fab.write(p, val)
        assert port.member_names == ref.member_names
        assert _counters(port) == _counters(ref)
        assert port.stats()["bytes_stored"] == 2 * 8 * 64
        per = {n: m["bytes_stored"]
               for n, m in port.stats()["members"].items()}
        assert per == {n: m["bytes_stored"]
                       for n, m in ref.stats()["members"].items()}
        assert set(port.stats()) == set(ref.stats())
        for p, val in v.items():
            np.testing.assert_array_equal(port.read(p), val)


def test_batched_roundtrip_bit_exact_across_shards():
    ref, port = _both(member="verbs", doorbell_batch=2)
    with ref, port:
        v = _vals(8, 64, seed=3)
        order = [7, 2, 5, 0, 1]
        outs = []
        for fab in (ref, port):
            fab.write_many_async(list(v), list(v.values())).wait()
            outs.append(fab.read_many(order))
        np.testing.assert_array_equal(outs[1], outs[0])
        for row, p in enumerate(order):
            np.testing.assert_array_equal(outs[1][row], v[p])
        assert _counters(port) == _counters(ref)


def test_read_fails_over_to_replica_on_marked_member():
    ref, port = _both()
    with ref, port:
        v = _vals(8, 64, seed=1)
        for fab in (ref, port):
            for p, val in v.items():
                fab.write(p, val)
            victim = fab.ring.owners(0)[0]
            fab.mark_failed(victim)
            np.testing.assert_array_equal(fab.read(0), v[0])
            assert fab.failovers >= 1 and fab.epoch == 1
        assert port.failed_members == ref.failed_members
        assert [e["kind"] for e in port.drain_events()] == \
            [e["kind"] for e in ref.drain_events()] == ["epoch", "fail"]


def test_unreplicated_failure_and_last_member_are_loud():
    ref, port = _both(replicas=1)
    with ref, port:
        v = _vals(8, 64, seed=2)
        for fab, mod in ((ref, RF), (port, PF)):
            for p, val in v.items():
                fab.write(p, val)
            fab.mark_failed(fab.ring.owners(0)[0])
            with pytest.raises(mod.FabricUnavailable, match="no alive"):
                fab.read(0)
    ref, port = _both(shards=2, replicas=1)
    with ref, port:
        for fab, mod in ((ref, RF), (port, PF)):
            fab.mark_failed(fab.member_names[0])
            with pytest.raises(mod.FabricUnavailable, match="last alive"):
                fab.mark_failed(fab.member_names[1])


def test_quorum_read_agreement_and_mismatch():
    ref, port = _both(shards=3, replicas=3)
    with ref, port:
        v = _vals(4, 64, seed=4)
        for fab, mod in ((ref, RF), (port, PF)):
            for p, val in v.items():
                fab.write(p, val)
            np.testing.assert_array_equal(fab.read_quorum(1), v[1])
            owners = fab.ring.owners(2)
            fab.member(owners[0]).write(2, np.zeros(64, np.uint8))
            fab.member(owners[1]).write(2, np.ones(64, np.uint8))
            with pytest.raises(mod.QuorumError, match="agreement"):
                fab.read_quorum(2)
        assert port.quorum_reads == ref.quorum_reads == 2


def test_congested_shard_reroutes_reads_per_member():
    """A primary with slow completions and work in flight on its page
    telemetry stops serving the read in both packages; the ring is
    untouched."""
    ref, port = _both()
    with ref, port:
        v = _vals(8, 64, seed=5)
        picks = []
        for fab in (ref, port):
            for p, val in v.items():
                fab.write(p, val)
            owners = fab.ring.owners(0)
            assert fab._pick_reader(0, 64, 1) == owners[0]
            src = fab.member(owners[0]).telemetry_source()
            for _ in range(4):
                fab.reactor.record(src, 0.05, 64)
            fab.reactor.on_submit(src)
            fab.reactor.on_submit(src)
            picks.append(fab._pick_reader(0, 64, 1))
            assert picks[-1] == owners[1]
            assert fab.ring.owners(0) == owners
            np.testing.assert_array_equal(fab.read(0), v[0])
        assert picks[0] == picks[1]


def test_epoch_propagates_into_member_nodes():
    ref, port = _both(member="verbs", shards=2, replicas=2)
    with ref, port:
        for fab in (ref, port):
            assert fab.epoch == 0
            fab.mark_failed(fab.member_names[0])
            survivor = fab.member(fab.member_names[1])
            assert survivor.backend.amap.epoch == fab.epoch == 1
            assert all(n.epoch == 1 for n in survivor.backend.amap.nodes)


def test_fabric_as_tiered_store_backend():
    outs = []
    for Store, kw in ((RefStore, {}), (PortStore, {"device": "cpu"})):
        with Store(10, (32,), dtype="float32", n_hot_slots=3,
                   path="fabric", member="xdma", shards=3, replicas=2,
                   n_channels=1, **kw) as st:
            for p in range(10):
                st.write_page(p, np.full(32, p, np.float32))
            st.ensure([0, 1, 2])
            st.update_page(1, np.full(32, 77.0, np.float32))
            st.ensure([3, 4, 5])            # evicts, dirty 1 written back
            res = st.ensure([1, 9])
            outs.append((float(np.asarray(res[1].cpu() if hasattr(
                res[1], "cpu") else res[1])[0]),
                st.stats()["cold"]["path"],
                st.stats()["cold"]["bytes_stored"]))
    assert outs[1] == outs[0] == (77.0, "fabric", outs[0][2])


def test_geometry_mismatch_and_rejected_build_leave_no_trace():
    a = port_path("xdma", n_pages=2, page_bytes=64, n_channels=1,
                  device="cpu")
    b = port_path("xdma", n_pages=4, page_bytes=64, n_channels=1,
                  device="cpu")
    try:
        with pytest.raises(ValueError, match="geometry"):
            PF.ShardedPath([a, b])
        assert a.name == "xdma" and b.name == "xdma"
    finally:
        a.close()
        b.close()
    before = threading.active_count()
    for mk, kw in ((ref_path, {}), (port_path, {"device": "cpu"})):
        with pytest.raises(ValueError, match="replicas"):
            mk("fabric", member="verbs", shards=2, replicas=3, n_pages=4,
               page_bytes=64, n_channels=1, **kw)
    assert threading.active_count() == before


def test_device_keyword_reaches_every_member(monkeypatch):
    """The registry's signature filter keeps ``device`` for the fabric:
    every member's pool and memory nodes land where it says, and the
    default (the card) raises without one."""
    with port_path("fabric", member="verbs", shards=2, replicas=2,
                   n_pages=4, page_bytes=64, n_channels=1,
                   device="cpu") as fab:
        for n in fab.member_names:
            m = fab.member(n)
            assert m.pool.device.type == "cpu"
            assert all(node.device.type == "cpu"
                       for node in m.backend.amap.nodes)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA device"):
        port_path("fabric", member="xdma", shards=2, n_pages=4,
                  page_bytes=64, n_channels=1)
    assert threading.active_count() == before


def test_member_telemetry_is_per_member_not_joint():
    fast = [port_path("verbs", n_pages=8, page_bytes=64, n_channels=1,
                      doorbell_batch=2, device="cpu") for _ in range(2)]
    slow = port_path("verbs", n_pages=8, page_bytes=64, n_channels=1,
                     doorbell_batch=2, node_latency_s=0.05, device="cpu")
    with PF.ShardedPath(fast + [slow], replicas=3) as fab:
        v = _vals(8, 64, seed=9)
        for _ in range(3):
            fab.write_many_async(list(v), list(v.values())).wait()
        t_fast = fab.reactor.stats_for(fab.source_of(fast[0].name))
        t_slow = fab.reactor.stats_for(fab.source_of(slow.name))
        assert t_slow.ewma_latency_s > 3 * t_fast.ewma_latency_s
        mgr = PF.FabricManager(fab, straggler_threshold=2.0, warmup=2)
        assert mgr.check_health() == [slow.name]


def _repair_view(stats):
    return {k: v for k, v in stats.items() if k != "seconds"}


@pytest.mark.parametrize("member", ["xdma", "verbs"])
def test_fail_node_repairs_like_the_reference(member):
    ref, port = _both(member=member, n_pages=16)
    with ref, port:
        v = _vals(16, 64, seed=6)
        repairs = []
        for fab, mod in ((ref, RF), (port, PF)):
            mgr = mod.FabricManager(fab)
            fab.write_many_async(list(v), list(v.values())).wait()
            victim = fab.member_names[0]
            repairs.append(mgr.fail_node(victim))
            for p, val in v.items():
                np.testing.assert_array_equal(fab.read(p), val)
                np.testing.assert_array_equal(fab.read_quorum(p), val)
            assert fab.epoch == 2 and victim not in fab.ring.members
            assert mgr.fail_node(victim)["noop"]
        assert _repair_view(repairs[1]) == _repair_view(repairs[0])
        assert repairs[1]["lost"] == 0 and repairs[1]["moved_pages"] > 0
        assert [e["kind"] for e in port.drain_events()] == \
            [e["kind"] for e in ref.drain_events()]


def test_fail_without_replica_raises_data_loss():
    ref, port = _both(replicas=1, n_pages=16)
    with ref, port:
        v = _vals(16, 64, seed=7)
        for fab, mod in ((ref, RF), (port, PF)):
            for p, val in v.items():
                fab.write(p, val)
            with pytest.raises(mod.FabricDataLoss, match="no surviving"):
                mod.FabricManager(fab).fail_node(fab.ring.primary(0))
        assert port.failed_members == ref.failed_members


def test_scale_out_moves_what_the_reference_moves():
    ref, port = _both(shards=4, replicas=1, n_pages=16)
    with ref, port:
        v = _vals(16, 64, seed=8)
        stats = []
        for fab, mod, mk, kw in ((ref, RF, ref_path, {}),
                                 (port, PF, port_path, {"device": "cpu"})):
            mgr = mod.FabricManager(fab)
            fab.write_many_async(list(v), list(v.values())).wait()
            new = mk("xdma", n_pages=16, page_bytes=64, n_channels=1,
                     **kw)
            stats.append(mgr.rebalance(add=[new]))
            assert new.name in fab.ring.members
            for p, val in v.items():
                np.testing.assert_array_equal(fab.read(p), val)
            assert fab.pages_moved == stats[-1]["moved_pages"]
        assert _repair_view(stats[1]) == _repair_view(stats[0])
        assert stats[1]["moved_fraction"] < 0.5


def test_straggler_detection_matches_reference():
    ref, port = _both()
    with ref, port:
        for fab, mod in ((ref, RF), (port, PF)):
            mgr = mod.FabricManager(fab, straggler_threshold=2.0,
                                    warmup=2)
            slow, fast = fab.member_names[0], fab.member_names[1]
            for _ in range(5):
                assert not mgr.record(fast, 0.01)
            for _ in range(5):
                mgr.record(slow, 0.01)
            assert mgr.record(slow, 0.1)
            assert mgr.suspects == [slow]
            for n in fab.member_names:
                lat = 0.5 if n == fab.member_names[-1] else 0.001
                for _ in range(4):
                    fab.reactor.record(fab.source_of(n), lat, 64)
            assert mgr.check_health() == [fab.member_names[-1]]


def test_close_closes_failed_members():
    """A killed member's pool threads live until the fabric closes, and
    the close reaches it."""
    before = threading.active_count()
    fab = port_path("fabric", member="xdma", shards=3, replicas=2,
                    n_pages=4, page_bytes=64, n_channels=2, device="cpu")
    victim = fab.member_names[-1]
    PF.FabricManager(fab).kill(victim)
    assert threading.active_count() > before
    fab.close()
    assert threading.active_count() == before
    assert not any(ch._alive for ch in fab.member(victim).pool.channels)


# ---------------------------------------------------------------------------
# the engine and the serve CLI
# ---------------------------------------------------------------------------

def _engine(**kw):
    cfg = port_reduce(port_config("qwen2-0.5b"))
    return ServeEngine(cfg, {}, batch_slots=2, max_len=32, device="cpu",
                       **kw)


def test_engine_validation_matches_reference():
    with pytest.raises(ValueError, match="kv_replicas >= 2"):
        _engine(access_path="xdma", kv_shards=4, kv_replicas=1,
                kv_kill_step=2)
    with pytest.raises(ValueError, match="kv_shards must be"):
        _engine(kv_shards=0)
    with pytest.raises(ValueError, match="must be in"):
        _engine(kv_shards=2, kv_replicas=3)
    eng = _engine(kv_shards=3, kv_replicas=2)     # sharding implies paging
    assert eng.access_path == "xdma" and eng.pager is not None
    assert eng.fabric.member_names == [f"xdma/s{i}" for i in range(3)]
    assert eng.pager.retry is None and eng.fabric.retry is None
    eng.close()
    with pytest.warns(DeprecationWarning, match="kv_nodes"):
        eng = _engine(kv_nodes=2)
    assert eng.kv_shards == 2 and len(eng.fabric.member_names) == 2
    eng.close()


def test_one_retry_layer_lives_in_the_fabric():
    from repro_torch.faults.retry import RetryPolicy
    pol = RetryPolicy(seed=1)
    eng = _engine(kv_shards=2, kv_replicas=2, kv_retry=pol,
                  kv_integrity=True)
    assert eng.fabric.retry is pol and eng.pager.retry is None
    assert eng.fabric.checksums is not None and eng.pager.checksums is None
    eng.close()
    eng = _engine(access_path="xdma", kv_retry=pol, kv_integrity=True)
    assert eng.fabric is None and eng.pager.retry is pol
    assert eng.pager.checksums is not None
    eng.close()


# A host-memory member completes inline, so an injected fault raises
# while the member's sub-op is being issued.  The port parks it and lets
# the fault-handling join retry or fail over; the reference's issue
# raises straight out of the batched call (ROADMAP C).
FT_MODES = {"retry": (True, False), "checksums": (False, True),
            "both": (True, True)}


def _issue_fault_setup(pkg, monkeypatch, mode, n_pages=16):
    from repro.faults import retry as ref_retry
    from repro.rmem import backend as ref_backend
    from repro_torch.faults import retry as port_retry
    from repro_torch.rmem import backend as port_backend
    for mod in (ref_backend.LocalHostBackend,
                port_backend.LocalHostBackend):
        monkeypatch.setattr(mod, "_scope_ids", itertools.count())
    retry, integrity = FT_MODES[mode]
    make, pol, kw = ((ref_path, ref_retry.RetryPolicy, {}) if pkg == "ref"
                     else (port_path, port_retry.RetryPolicy,
                           {"device": "cpu"}))
    fab = make("fabric", member="xdma", shards=4, replicas=2,
               n_pages=n_pages, page_bytes=64, n_channels=1,
               retry=pol(seed=1) if retry else None, integrity=integrity,
               **kw)
    bad = fab.member_names[1]
    # route every read of a page that ``bad`` owns to ``bad``, so the
    # injected faults are hit whatever the measured latencies say
    pick = fab._pick_reader
    monkeypatch.setattr(fab, "_pick_reader", lambda p, nbytes, batch:
                        bad if bad in fab._owners(p)
                        else pick(p, nbytes, batch))
    return fab, bad


def _plan(inj, fab, bad, kind):
    from repro_torch.launch.serve import _fault_scopes
    scopes = _fault_scopes(fab.member(bad))
    if kind == "flap":
        return inj.FaultPlan(seed=3, flaps={scopes[0]: [(0, 10**6)]})
    return inj.FaultPlan(seed=3, error_rate=0.5, only_scopes=scopes)


@pytest.mark.parametrize("kind", ["flap", "errors"])
@pytest.mark.parametrize("mode", list(FT_MODES))
def test_batched_read_survives_issue_time_faults_on_one_member(
        monkeypatch, mode, kind):
    from repro_torch.faults import injector as inj
    fab, bad = _issue_fault_setup("port", monkeypatch, mode)
    with fab:
        v = _vals(16, 64, seed=5)
        fab.write_many_async(list(v), list(v.values())).wait()
        order = list(np.random.default_rng(2).permutation(16))
        plan = inj.install(_plan(inj, fab, bad, kind))
        try:
            got = fab.read_many_async(order).wait()
        finally:
            inj.uninstall()
        for row, p in enumerate(order):
            np.testing.assert_array_equal(got[row], v[p])
        hit = plan.snapshot()
        assert hit["flap_rejections" if kind == "flap" else "errors"] > 0
        retried = fab.retry.stats()["retries"] if fab.retry else 0
        assert fab.failovers > 0 or retried > 0


@pytest.mark.parametrize("mode", list(FT_MODES))
def test_batched_write_survives_a_member_down_at_issue(monkeypatch, mode):
    from repro.faults import injector as ref_inj
    from repro.faults.retry import TransientIOError as RefTransient
    from repro_torch.faults import injector as inj
    v = _vals(16, 64, seed=6)
    fab, bad = _issue_fault_setup("port", monkeypatch, mode)
    with fab:
        inj.install(_plan(inj, fab, bad, "flap"))
        try:
            fab.write_many_async(list(v), list(v.values())).wait()
            got = fab.read_many(list(v))
        finally:
            inj.uninstall()
        np.testing.assert_array_equal(got, np.stack(list(v.values())))
        assert fab.degraded_writes > 0 and fab.under_replicated_pages
    # the reference raises out of the same batched write while issuing it
    ref, rbad = _issue_fault_setup("ref", monkeypatch, mode)
    with ref:
        ref_inj.install(_plan(ref_inj, ref, rbad, "flap"))
        try:
            with pytest.raises(RefTransient):
                ref.write_many_async(list(v), list(v.values()))
        finally:
            ref_inj.uninstall()


def test_quorum_read_outvotes_a_member_down_at_issue(monkeypatch):
    from repro_torch.faults import injector as inj
    from repro_torch.rmem.backend import LocalHostBackend
    monkeypatch.setattr(LocalHostBackend, "_scope_ids", itertools.count())
    fab = port_path("fabric", member="xdma", shards=4, replicas=3,
                    n_pages=8, page_bytes=64, n_channels=1, device="cpu")
    with fab:
        v = _vals(8, 64, seed=8)
        fab.write_many(list(v), list(v.values()))
        bad = fab.member_names[2]
        mine = [p for p in v if bad in fab.ring.owners(p)]
        plan = inj.install(_plan(inj, fab, bad, "flap"))
        try:
            for p in mine:
                np.testing.assert_array_equal(fab.read_quorum(p), v[p])
        finally:
            inj.uninstall()
        assert mine and plan.snapshot()["flap_rejections"] == len(mine)


def test_issue_time_fault_propagates_without_fault_handling(monkeypatch):
    from repro_torch.faults import injector as inj
    from repro_torch.faults.retry import NodeUnavailable
    fab = port_path("fabric", member="xdma", shards=4, replicas=2,
                    n_pages=16, page_bytes=64, n_channels=1, device="cpu")
    with fab:
        v = _vals(16, 64, seed=7)
        inj.install(_plan(inj, fab, fab.member_names[1], "flap"))
        try:
            with pytest.raises(NodeUnavailable):
                fab.write_many_async(list(v), list(v.values()))
        finally:
            inj.uninstall()


@pytest.fixture(scope="module")
def qwen_model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, pcfg, params, pparams


def swap_weights(monkeypatch, model):
    cfg, pcfg, params, pparams = model
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)


@pytest.fixture
def clean_obs():
    """Both packages' tracing off and metric registries empty around the
    test, so a snapshot holds only its own runs."""
    from repro import obs as robs
    from repro_torch import obs as pobs

    def reset():
        for o in (robs, pobs):
            o.trace.disable()
            o.metrics.disable_live()
            o.default_registry().clear()
    reset()
    yield
    reset()


_SOURCE_ID = re.compile(r"#\d+")


def keys_of(d):
    """The key set of a nested dict, level by level.  Reactor source ids
    (``xdma#4:page``) carry a process-wide counter, so their numbers are
    dropped; ``placement`` maps what each package's own models chose."""
    return {_SOURCE_ID.sub("#", str(k)):
            (None if k == "placement" else keys_of(v))
            if isinstance(v, dict) else None for k, v in d.items()}


KILL_FLAGS = ["--kv-shards", "4", "--kv-replicas", "2",
              "--kv-kill-node", "3"]


@pytest.mark.parametrize("path", ["xdma", "verbs"])
def test_cli_sharded_kill_matches_reference(monkeypatch, capsys,
                                            qwen_model, clean_obs, path):
    """``--kv-shards 4 --kv-replicas 2 --kv-kill-node 3`` with the
    reference's float32 weights in both CLIs: the reference's tokens,
    repair plan and event kinds, and its result keys at every level
    (``fabric`` and ``metrics`` included)."""
    swap_weights(monkeypatch, qwen_model)
    flags = ["--smoke", "--requests", "4", "--max-new", "4", "--slots",
             "2", "--prompt-len", "6", "--access-path", path,
             "--metrics"] + KILL_FLAGS
    want = ref_serve.main(flags)
    capsys.readouterr()
    got = port_serve.main(flags + ["--device", "cpu"])
    assert "[serve:fabric] shards=4 replicas=2" in capsys.readouterr().out
    assert got["outputs"] == want["outputs"]
    assert got["undrained"] == want["undrained"] == 0
    assert keys_of(got) == keys_of(want)
    fb, rfb = got["fabric"], want["fabric"]
    assert fb["killed"] == rfb["killed"] == f"{path}/s3"
    assert fb["kill_step"] == rfb["kill_step"] == 3
    assert _repair_view(fb["repair"]) == _repair_view(rfb["repair"])
    assert fb["repair"]["lost"] == 0
    for k in ("epoch", "failed", "pages_moved", "replicated_writes"):
        assert fb[k] == rfb[k], k
    assert [(e["kind"], e["step"]) for e in fb["events"]] == \
        [(e["kind"], e["step"]) for e in rfb["events"]]
    assert got["install"] == want["install"]
    for k in ("h2c_bytes", "c2h_bytes", "evictions", "page_bytes"):
        assert got["kv"][k] == want["kv"][k], k
    assert got["kv"]["cold"]["bytes_stored"] == \
        want["kv"]["cold"]["bytes_stored"]


def test_cli_kv_nodes_alias_warns_and_matches_kv_shards(capsys):
    flags = ["--smoke", "--requests", "2", "--max-new", "3", "--slots",
             "2", "--prompt-len", "6", "--device", "cpu"]
    with pytest.warns(DeprecationWarning, match="--kv-nodes"):
        alias = port_serve.main(flags + ["--kv-nodes", "2"])
    shards = port_serve.main(flags + ["--kv-shards", "2"])
    plain = port_serve.main(flags)
    assert alias["outputs"] == shards["outputs"] == plain["outputs"]
    assert alias["fabric"]["shards"] == shards["fabric"]["shards"] == 2
    assert "fabric" not in plain and "kv" not in plain
