"""The port's access layer against the reference's: QDMA descriptor
queues and the ``QueueEngine`` scheduler, ``QdmaPath`` and ``VerbsPath``
page and stage round trips (byte for byte, with the reference's stats
key set), ``MemoryEngine(path=...)`` ownership, the analytical models,
and the ``PathSelector``: its decisions equal the reference's under the
same models, equal its own models' argmin when idle, and reroute around
a contended verbs path."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.access import create_path as ref_create  # noqa: E402
from repro.core import analytical as ref_an  # noqa: E402
from repro.core import descriptors as ref_desc  # noqa: E402
from repro.core.channels import Direction as RefDirection  # noqa: E402
from repro_torch.access import (PathSelector, QdmaPath,  # noqa: E402
                                VerbsPath, XdmaPath, create_path)
from repro_torch.core import (ChannelPool, MemoryEngine,  # noqa: E402
                              QueueEngine)
from repro_torch.core import analytical as an  # noqa: E402
from repro_torch.core import descriptors as desc  # noqa: E402
from repro_torch.core.channels import Direction  # noqa: E402
from repro_torch.rmem import TieredStore  # noqa: E402
from repro_torch.rmem.backend import PendingIO  # noqa: E402

PATHS = ("xdma", "qdma", "verbs", "auto")
CPU = {"device": "cpu"}


def _keys(d):
    """The key set of a nested dict, level by level."""
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _round_trip(create, name, **kw):
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 256, (4, 128), dtype=np.uint8)
    out = {}
    with create(name, n_pages=4, page_bytes=128, n_channels=1,
                doorbell_batch=2, **kw) as p:
        p.write(0, vals[0])
        out["read"] = p.read(0)
        p.write_many([1, 2, 3], list(vals[1:]))
        out["many"] = p.read_many([3, 1])
        io = p.read_many_async([2])
        out["async"] = io.wait()
        x = np.arange(64, dtype=np.float32)
        dev = p.stage_h2c(x).wait()
        out["stage"] = np.asarray(p.stage_c2h(dev).wait())
        stats = p.stats()
    return vals, out, stats, io


@pytest.mark.parametrize("name", PATHS)
def test_page_and_stage_round_trip_match_reference(name):
    vals, want, ws, _ = _round_trip(ref_create, name)
    _, got, gs, io = _round_trip(create_path, name, **CPU)
    assert isinstance(io, PendingIO)
    np.testing.assert_array_equal(got["read"], vals[0])
    np.testing.assert_array_equal(got["many"], vals[[3, 1]])
    np.testing.assert_array_equal(got["async"][0], vals[2])
    np.testing.assert_array_equal(got["stage"], np.arange(64))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the reference's stats schema, mechanism detail included (queues
    # and channels for qdma, the QP and node counters for verbs)
    assert _keys(gs) == _keys(ws)
    for k in ("path", "bytes_moved", "ops"):
        assert gs[k] == ws[k], k
    if name == "verbs":
        assert gs["qp"] == ws["qp"]
        assert [{k: v for k, v in n.items()} for n in gs["nodes"]] == \
            ws["nodes"]
    if name == "qdma":
        assert gs["queues"] == ws["queues"]


@pytest.mark.parametrize("name", ["qdma", "verbs"])
def test_stage_only_paths_and_capabilities(name):
    with create_path(name, n_channels=1, **CPU) as p:
        caps = p.capabilities()
        assert caps.kind == name
        assert caps.projected_seconds(1 << 20) > \
            caps.projected_seconds(1 << 10)
        with pytest.raises(RuntimeError, match="stage-only"):
            p.read(0)
    with ref_create(name, n_channels=1) as r:
        rc = r.capabilities()
    assert (caps.granularity_bytes, caps.max_inflight, caps.batch_coalescing,
            caps.channels) == (rc.granularity_bytes, rc.max_inflight,
                               rc.batch_coalescing, rc.channels)


def test_models_rebase_on_the_h100_host_path():
    host, q, far = an.h100_host_path(), an.qdma_host_path(), \
        an.far_memory_path()
    assert q == dataclasses.replace(host, t0_us=18.0)
    assert q.link_gbps == an.H100_PINNED_H2D_GBPS
    # the RNIC model is no TPU figure: the reference's constants
    assert dataclasses.asdict(far) == dataclasses.asdict(
        ref_an.far_memory_path())
    assert ref_an.qdma_host_path().t0_us == q.t0_us
    for size, batch in [(64, 1), (4096, 8), (1 << 20, 4)]:
        assert an.doorbell_bandwidth_gbps(far, size, batch) == \
            pytest.approx(ref_an.doorbell_bandwidth_gbps(
                ref_an.far_memory_path(), size, batch))
    with create_path("qdma", n_channels=1, **CPU) as qp, \
            create_path("xdma", n_channels=1, **CPU) as xp, \
            create_path("verbs", n_channels=1, **CPU) as vp:
        assert qp.capabilities().model == q
        assert xp.capabilities().model == host
        assert vp.capabilities().model == far
        assert vp.capabilities().stage_model == host
        qc = qp.capabilities()
        assert qc.projected_seconds(4096, batch=8) < \
            qc.projected_seconds(4096, batch=1)


def test_descriptors_match_reference():
    sg, rows = desc.spans_for_packing([5, 9, 3, 12], 8)
    rsg, rrows = ref_desc.spans_for_packing([5, 9, 3, 12], 8)
    assert [(d.src_offset, d.dst_offset, d.nbytes) for d in sg] == \
        [(d.src_offset, d.dst_offset, d.nbytes) for d in rsg]
    assert rows == rrows
    src = np.arange(29 * 4, dtype=np.uint8)
    np.testing.assert_array_equal(desc.gather(src, sg),
                                  ref_desc.gather(src, rsg))
    assert [len(l) for l in sg.chunked(6).round_robin(3)] == \
        [len(l) for l in rsg.chunked(6).round_robin(3)]


class TestQueues:
    def test_queue_engine_owns_created_pool(self):
        qe = QueueEngine(n_channels=1, **CPU)
        assert qe.owns_pool
        qe.create_queue("kv", depth=4, weight=2)
        item = qe.submit("kv", np.arange(8, dtype=np.int32),
                         Direction.H2C)
        assert item.stream is None               # no CUDA stream to carry
        got = qe.wait(item)
        np.testing.assert_array_equal(got.numpy(), np.arange(8))
        assert qe.queues["kv"].completed == 1
        with pytest.raises(ValueError, match="exists"):
            qe.create_queue("kv")
        qe.close()
        qe.close()                               # idempotent
        assert not qe.pool.channels[0]._alive

    def test_idle_scheduler_sleeps_until_an_enqueue(self):
        """An idle scheduler blocks (a few rounds in 0.2 s, where a
        0.2 ms poll would take a thousand); an enqueue straight on the
        ring wakes it."""
        import time
        from repro_torch.core.queues import WorkItem
        qe = QueueEngine(n_channels=1, **CPU)
        q = qe.create_queue("kv")
        rounds = []
        real = qe._drain_once
        qe._drain_once = lambda: rounds.append(1) or real()
        time.sleep(0.2)
        assert len(rounds) < 20, len(rounds)
        item = WorkItem(np.arange(4, dtype=np.int32), Direction.H2C)
        q.enqueue(item)
        np.testing.assert_array_equal(qe.wait(item, 5.0).numpy(),
                                      np.arange(4))
        qe.close()

    def test_shared_pool_survives_engine_close(self):
        with ChannelPool(1, **CPU) as pool:
            qe = QueueEngine(pool=pool)
            assert not qe.owns_pool
            qe.close()
            assert pool.channels[0]._alive

    def test_submit_error_reaches_the_submitter(self):
        qe = QueueEngine(n_channels=1, **CPU)
        qe.create_queue("q")
        item = qe.submit("q", np.zeros(4), Direction.C2H)  # not a tensor
        with pytest.raises(ValueError, match="C2H takes a tensor"):
            item.assigned.wait(5.0)
        qe.close()

    def test_memory_engine_over_qdma_and_ownership(self):
        eng = MemoryEngine(n_channels=1, path="qdma", **CPU)
        assert isinstance(eng.path, QdmaPath) and eng.qdma is not None
        dev = eng.write(np.ones(256, np.float32)).wait()
        np.testing.assert_array_equal(eng.read(dev).wait(),
                                      np.ones(256, np.float32))
        s = eng.stats()
        assert s["path"] == "qdma" and s["bytes_moved"] == 2 * 1024
        assert s["queues"]["default"]["completed"] == 2
        qdma = eng.qdma
        eng.close()
        eng.close()
        assert qdma._closed
        with create_path("xdma", n_channels=1, **CPU) as p:
            eng2 = MemoryEngine(path=p)
            eng2.close()
            assert p.pool.channels[0]._alive


def _same_models(port_sel, ref_sel):
    """Give each port member the reference member's models."""
    ref = {p.name: p.capabilities() for p in ref_sel.paths}
    for p in port_sel.paths:
        rc = ref[p.name]
        conv = (lambda m: None if m is None else
                an.PathModel(**dataclasses.asdict(m)))
        p._caps = dataclasses.replace(p._caps, model=conv(rc.model),
                                      stage_model=conv(rc.stage_model))


SIZES = [64, 4096, 1 << 14, 1 << 16, 1 << 20, 1 << 24]
BATCHES = [1, 2, 8, 32]


class TestSelector:
    def test_decisions_equal_reference_under_the_same_models(self):
        kw = dict(n_pages=4, page_bytes=1 << 20, n_channels=2,
                  doorbell_batch=4)
        with ref_create("auto", **kw) as rs, \
                create_path("auto", **kw, **CPU) as ps:
            _same_models(ps, rs)
            chosen = set()
            for nbytes in SIZES:
                for batch in BATCHES:
                    for d, rd in ((Direction.H2C, RefDirection.H2C),
                                  (Direction.C2H, RefDirection.C2H)):
                        for stage in (False, True):
                            got = ps.select(nbytes, batch, d, stage=stage)
                            want = rs.select(nbytes, batch, rd, stage=stage)
                            assert got.name == want.name, \
                                (nbytes, batch, d, stage)
                            g, w = ps.decisions[-1], rs.decisions[-1]
                            assert g.projected == pytest.approx(w.projected)
                            assert g.scores == pytest.approx(w.scores)
                            chosen.add(got.name)
            assert chosen == {"xdma", "qdma", "verbs"}

    def test_idle_decisions_are_the_port_models_argmin(self):
        with create_path("auto", n_pages=4, page_bytes=1 << 20,
                         n_channels=2, doorbell_batch=4, **CPU) as sel:
            assert isinstance(sel, PathSelector)
            assert sorted(p.name for p in sel.paths) == \
                ["qdma", "verbs", "xdma"]
            for nbytes in SIZES:
                for batch in BATCHES:
                    got = sel.select(nbytes, batch, Direction.H2C)
                    proj = {p.name: p.capabilities().projected_seconds(
                        nbytes, batch, Direction.H2C) for p in sel.paths}
                    d = sel.decisions[-1]
                    assert not d.measured
                    assert got.name == d.model_argmin == \
                        min(proj, key=proj.get), (nbytes, batch)
            # small single ops go verbs, large singles xdma
            assert sel.select(4096, 1, Direction.H2C).name == "verbs"
            assert sel.select(1 << 20, 1, Direction.H2C).name == "xdma"

    def test_stage_only_selector_members(self):
        with create_path("auto", n_channels=1, **CPU) as sel:
            assert [p.name for p in sel.paths] == ["xdma", "qdma"]
            dev = sel.stage_h2c(np.arange(16, dtype=np.float32)).wait()
            np.testing.assert_array_equal(sel.stage_c2h(dev).wait(),
                                          np.arange(16))
            assert [d.op for d in sel.decisions] == ["stage_h2c",
                                                     "stage_c2h"]

    def test_measured_latency_steers_under_contention(self):
        """Idle decisions stay on the model argmin; eight 50 ms doorbells
        in flight on verbs reroute the same request, with the measured
        delay recorded."""
        with create_path("auto", n_pages=8, page_bytes=4096,
                         n_channels=1, doorbell_batch=1,
                         node_latency_s=0.05, **CPU) as sel:
            verbs = next(p for p in sel.paths if p.name == "verbs")
            val = np.zeros(4096, np.uint8)
            for p in sel.paths:
                for page in range(4):
                    p.write(page, val)
                    p.read(page)
            sel.select(4096, 1, Direction.H2C)
            d = sel.decisions[-1]
            assert not d.measured and d.observed == {}
            assert d.chosen == d.model_argmin == "verbs"
            io = verbs.write_many_async(list(range(8)), [val] * 8)
            try:
                assert verbs.backend.qp.outstanding_wrs > 0
                got = sel.select(4096, 1, Direction.H2C)
                d = sel.decisions[-1]
                assert d.measured and d.observed["verbs"] > 0
                assert d.model_argmin == "verbs"
                assert got.name != "verbs"
            finally:
                io.wait(30.0)

    def test_reads_follow_placement_across_paths(self):
        with create_path("auto", n_pages=6, page_bytes=256, n_channels=2,
                         doorbell_batch=4, **CPU) as sel:
            by_name = {p.name: p for p in sel.paths}
            rng = np.random.default_rng(7)
            vals = rng.integers(0, 256, (6, 256), dtype=np.uint8)
            owners = ["xdma", "verbs", "qdma", "verbs", "xdma", "qdma"]
            for page, owner in enumerate(owners):
                by_name[owner].write(page, vals[page])
                sel._placement[page] = by_name[owner]
            order = [5, 0, 3, 1, 4, 2]
            np.testing.assert_array_equal(sel.read_many(order), vals[order])

    def test_selector_as_tiered_store_backend(self):
        with TieredStore(6, (32,), dtype="float32", n_hot_slots=2,
                         path="auto", n_channels=1, doorbell_batch=2,
                         **CPU) as st:
            assert isinstance(st.path, PathSelector)
            for p in range(6):
                st.write_page(p, np.full(32, p, np.float32))
            assert float(st.ensure([1, 4])[4][0]) == 4.0
            st.ensure([2, 5])
            assert float(st.ensure([1, 3])[1][0]) == 1.0
            s = st.stats()
            assert s["cold"]["path"] == "auto" and s["cold"]["placement"]


def test_registry_filters_kwargs_and_names():
    from repro.access import DEFAULT_REGISTRY as REF_REGISTRY
    from repro_torch.access import DEFAULT_REGISTRY
    assert DEFAULT_REGISTRY.names() == REF_REGISTRY.names() == \
        ["auto", "fabric", "qdma", "verbs", "xdma"]
    with create_path("xdma", n_pages=1, page_bytes=32, n_channels=1,
                     n_nodes=7, doorbell_batch=3, node_latency_s=0.1,
                     **CPU) as p:
        assert isinstance(p, XdmaPath)
    with create_path("verbs", n_pages=2, page_bytes=32, n_nodes=2,
                     node_latency_s=0.0, **CPU) as p:
        assert isinstance(p, VerbsPath) and len(p.backend.amap.nodes) == 2
        assert all(n.device.type == "cpu" for n in p.backend.amap.nodes)
    with pytest.raises(ValueError, match="unknown access path"):
        create_path("rdma")
