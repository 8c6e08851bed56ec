"""The port's fault wiring against the reference's: the injector draws
the same schedule for one seed and scope; a memory node under a plan
runs every WR on its own and fails, corrupts and counts exactly as the
reference's node does; the verbs completion queue's straggler hook and
the membership epochs behave alike; and the serve CLI's sharded chaos
run gives the reference's tokens with both packages' fault-scope
counters started at 0."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core.channels import CompletionMode as RefMode  # noqa: E402
from repro.faults import injector as ref_inj  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.rmem import backend as ref_backend  # noqa: E402
from repro.rmem import node as ref_node  # noqa: E402
from repro.rmem import verbs as ref_verbs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.core.channels import CompletionMode  # noqa: E402
from repro_torch.faults import injector as port_inj  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.rmem import backend as port_backend  # noqa: E402
from repro_torch.rmem import node as port_node  # noqa: E402
from repro_torch.rmem import verbs as port_verbs  # noqa: E402

REF = (ref_inj, ref_verbs, ref_node, RefMode, {})
PORT = (port_inj, port_verbs, port_node, CompletionMode, {"device": "cpu"})


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test leaves both packages' fault gates closed."""
    yield
    ref_inj.uninstall()
    port_inj.uninstall()


def _schedule(plan, scope, n=80):
    out = []
    for _ in range(n):
        try:
            plan.before_op(scope)
            out.append(None)
        except Exception as e:
            out.append(type(e).__name__)
    return out


PLANS = [dict(error_rate=0.2, timeout_rate=0.1, straggler_rate=0.1,
              straggler_s=0.0),
         dict(error_rate=0.05, timeout_rate=0.02,
              flaps={"memnode0#3": [(5, 25)]}),
         dict(error_rate=0.5, only_scopes=["memnode"])]


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("scope", ["memnode0#3", "local-host#0",
                                   "verbs-cq4"])
@pytest.mark.parametrize("kw", PLANS, ids=["rates", "flap", "only"])
def test_injector_schedules_equal_across_packages(seed, scope, kw):
    ref = ref_inj.FaultPlan(seed, **kw)
    port = port_inj.FaultPlan(seed, **kw)
    assert _schedule(port, scope) == _schedule(ref, scope)
    assert port.snapshot() == ref.snapshot()
    bufs = [np.zeros(64, np.uint8) for _ in range(2)]
    ref_c = ref_inj.FaultPlan(seed, corrupt_rate=1.0, max_corruptions=1)
    port_c = port_inj.FaultPlan(seed, corrupt_rate=1.0, max_corruptions=1)
    assert ref_c.corrupt(scope, bufs[0]) and port_c.corrupt(scope, bufs[1])
    np.testing.assert_array_equal(bufs[1], bufs[0])
    assert not port_c.corrupt(scope, bufs[1])        # the cap holds


def _drive(pkg, plan_kw, seed=3, doorbell=4, n_wr=8):
    """Writes then reads of ``n_wr`` 64-byte WRs through one node under
    an installed plan, the node's scope pinned to ``memnode0#0`` in both
    packages; failed doorbells are fenced until the QP drains."""
    inj, verbs, node_mod, modes, kw = pkg
    node = node_mod.MemoryNode("memnode0", 4096, **kw)
    node.fault_scope = "memnode0#0"
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, 2 * n_wr * 64, dtype=np.uint8)
    sent = buf.copy()
    mr = verbs.MemoryRegion(buf)
    cq = verbs.CompletionQueue(modes.POLLED)
    qp = verbs.QueuePair(node, cq, doorbell_batch=doorbell)
    plan = inj.install(inj.FaultPlan(seed, **plan_kw))
    errors = []

    def fence():
        for _ in range(4 * n_wr):
            try:
                qp.flush()
                return
            except Exception as e:
                errors.append(type(e).__name__)
    try:
        for i in range(n_wr):
            qp.post_write(mr, 64 * i, 64 * i, 64, signaled=True)
        fence()
        for i in range(n_wr):
            qp.post_read(mr, 64 * (n_wr + i), 64 * i, 64, signaled=True)
        fence()
    finally:
        inj.uninstall()
    wcs = sorted((w.wr_id, w.opcode.value, w.status.value)
                 for w in cq.poll(1024))
    out = {"pool": node.pool[:n_wr * 64].copy(), "mr": buf.copy(),
           "sent": sent, "node": node.stats(), "plan": plan.snapshot(),
           "errors": errors, "wcs": wcs}
    qp.close()
    cq.close()
    node.close()
    return out


@pytest.mark.parametrize("plan_kw", [
    dict(error_rate=0.3), dict(error_rate=0.1, timeout_rate=0.1),
    dict(flaps={"memnode0": [(3, 6)]}), dict()],
    ids=["errors", "errors+timeouts", "flap", "no-faults"])
def test_node_hooks_match_reference(plan_kw):
    """Under an installed plan each WR draws its own fault and runs
    alone (no coalesced run): the same WRs fail, the pools and MRs hold
    the same bytes, and ``staged_hops`` counts one hop a WR, as the
    reference's node does."""
    want = _drive(REF, plan_kw)
    got = _drive(PORT, plan_kw)
    assert got["plan"] == want["plan"]
    assert got["errors"] == want["errors"]
    assert got["wcs"] == want["wcs"]
    assert got["node"] == want["node"]
    np.testing.assert_array_equal(got["pool"], want["pool"])
    np.testing.assert_array_equal(got["mr"], want["mr"])
    assert got["node"]["coalesced_runs"] == 0
    assert got["node"]["staged_hops"] == got["node"]["ops"]
    if not plan_kw:
        assert not got["errors"]


@pytest.mark.parametrize("op", ["write", "read"])
def test_corruption_lands_on_the_host_buffer_the_hop_filled(op):
    """A bit-flip on a write lands in the node's pool; on a read, in the
    MR the read filled — never in the node's device copy, and exactly
    where the reference's flip lands."""
    outs = []
    for pkg in (REF, PORT):
        inj, verbs, node_mod, modes, kw = pkg
        node = node_mod.MemoryNode("memnode0", 1024, **kw)
        node.fault_scope = "memnode0#0"
        data = np.arange(64, dtype=np.uint8)
        mr = verbs.MemoryRegion(np.concatenate([data, np.zeros(64,
                                                               np.uint8)]))
        qp = verbs.QueuePair(node, doorbell_batch=1)
        if op == "read":
            qp.write(mr, 0, 0, 64)
        plan = inj.install(inj.FaultPlan(11, corrupt_rate=1.0))
        try:
            if op == "write":
                qp.write(mr, 0, 0, 64)
            else:
                qp.read(mr, 64, 0, 64)
        finally:
            inj.uninstall()
        outs.append((node.pool[:64].copy(), mr.view(64, 64).copy(),
                     plan.snapshot()["corruptions"]))
        qp.close()
        node.close()
    (rpool, rmr, rn), (ppool, pmr, pn) = outs
    assert rn == pn == 1
    np.testing.assert_array_equal(ppool, rpool)
    np.testing.assert_array_equal(pmr, rmr)
    data = np.arange(64, dtype=np.uint8)
    if op == "write":
        assert int(np.unpackbits(ppool ^ data).sum()) == 1
    else:
        np.testing.assert_array_equal(ppool, data)     # pool intact
        assert int(np.unpackbits(pmr ^ data).sum()) == 1


def test_completion_queue_straggler_hook():
    """The CQ draws a straggler-only delay per delivered completion (it
    never fails an executed WR): both packages count one draw a push."""
    counts = []
    for pkg in (REF, PORT):
        inj, verbs, node_mod, modes, kw = pkg
        node = node_mod.MemoryNode("n", 1024, **kw)
        mr = verbs.MemoryRegion(np.arange(256, dtype=np.uint8))
        cq = verbs.CompletionQueue(modes.POLLED)
        qp = verbs.QueuePair(node, cq, doorbell_batch=2)
        plan = inj.install(inj.FaultPlan(
            1, straggler_rate=1.0, straggler_s=0.0,
            only_scopes=["verbs-cq"]))
        try:
            for i in range(4):
                qp.post_write(mr, 64 * i, 64 * i, 64, signaled=True)
            qp.flush()
        finally:
            inj.uninstall()
        n_wc = len(cq.poll(64))
        counts.append((plan.snapshot()["straggles"], n_wc,
                       plan.snapshot()["errors"]))
        qp.close()
        cq.close()
        node.close()
    assert counts[1] == counts[0]
    assert counts[1][0] == counts[1][1] == 4 and counts[1][2] == 0


def test_scope_names_follow_the_reference_counters(monkeypatch):
    for mod in (ref_node.MemoryNode, port_node.MemoryNode,
                ref_backend.LocalHostBackend,
                port_backend.LocalHostBackend):
        monkeypatch.setattr(mod, "_scope_ids", itertools.count())
    names = []
    for node_mod, backend_mod, kw in ((ref_node, ref_backend, {}),
                                      (port_node, port_backend,
                                       {"device": "cpu"})):
        ns = [node_mod.MemoryNode("memnode0", 64, **kw) for _ in range(2)]
        bs = [backend_mod.LocalHostBackend(2, 64) for _ in range(2)]
        names.append([n.fault_scope for n in ns] +
                     [b.fault_scope for b in bs])
        for n in ns:
            n.close()
    assert names[1] == names[0] == ["memnode0#0", "memnode0#1",
                                    "local-host#0", "local-host#1"]


def test_epochs_are_monotonic_and_stamp_every_node():
    for node_mod, kw in ((ref_node, {}), (port_node, {"device": "cpu"})):
        nodes = [node_mod.MemoryNode(f"m{i}", 4096, **kw)
                 for i in range(2)]
        amap = node_mod.AddressMap.striped(nodes, 6000)
        assert amap.epoch == 0 and all(n.epoch == 0 for n in nodes)
        amap.set_epoch(3)
        assert [n.epoch for n in nodes] == [3, 3]
        amap.set_epoch(3)                       # equal is fine
        with pytest.raises(ValueError, match="monotonic"):
            amap.set_epoch(2)
        with pytest.raises(ValueError, match="monotonic"):
            nodes[0].set_epoch(1)
        for n in nodes:
            n.close()


# ---------------------------------------------------------------------------
# the serve CLI under a fault plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, pcfg, params, pparams


CHAOS = ["--kv-shards", "3", "--kv-replicas", "2", "--fault-seed", "7",
         "--fault-rate", "0.05", "--fault-corrupt", "0.2",
         "--fault-flap", "2:12"]


def _reset_scopes(monkeypatch):
    for mod in (ref_node.MemoryNode, port_node.MemoryNode,
                ref_backend.LocalHostBackend,
                port_backend.LocalHostBackend):
        monkeypatch.setattr(mod, "_scope_ids", itertools.count())


def _reset_obs():
    from repro import obs as robs
    from repro_torch import obs as pobs
    for o in (robs, pobs):
        o.trace.disable()
        o.metrics.disable_live()
        o.default_registry().clear()


@pytest.mark.parametrize("path", ["xdma", "verbs"])
def test_cli_chaos_run_matches_reference(monkeypatch, qwen_model, path):
    """The sharded chaos flags over xdma and verbs members, the
    reference's float32 weights in both CLIs and both scope counters at
    0: the fault-free baseline's tokens, nothing shed or undrained, the
    same flapped scope and the reference's result keys at every level,
    ``metrics`` included.  The plan's counters, the retry stats and the
    key sets are held equal to the reference's when two runs of the
    reference agree (every CPU run seen so far did: replica routing
    reads measured latencies, so which member serves a read, and so
    which scope draws, could in principle vary)."""
    from test_torch_fabric import keys_of
    cfg, pcfg, params, pparams = qwen_model
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    base = ["--smoke", "--requests", "3", "--max-new", "4", "--slots",
            "2", "--prompt-len", "5", "--access-path", path]
    plain = ref_serve.main(base)
    runs = []
    try:
        for main, extra in ((ref_serve.main, []), (ref_serve.main, []),
                            (port_serve.main, ["--device", "cpu"])):
            _reset_scopes(monkeypatch)
            _reset_obs()
            runs.append(main(base + CHAOS + ["--metrics"] + extra))
    finally:
        _reset_obs()
    ref1, ref2, got = runs
    assert got["outputs"] == ref1["outputs"] == plain["outputs"]
    assert got["shed"] == 0 and got["undrained"] == 0
    assert set(got) == set(ref1)
    assert set(got["faults"]) == set(ref1["faults"])
    assert set(got["fabric"]) == set(ref1["fabric"])
    assert got["faults"]["flaps"] == ref1["faults"]["flaps"]
    assert got["faults"]["plan"]["seed"] == 7
    if ref1["faults"]["plan"] == ref2["faults"]["plan"] and \
            ref1["faults"]["retry"] == ref2["faults"]["retry"]:
        assert got["faults"]["plan"] == ref1["faults"]["plan"]
        assert got["faults"]["retry"] == ref1["faults"]["retry"]
    if keys_of(ref1) == keys_of(ref2):
        assert keys_of(got) == keys_of(ref1)


def test_cli_unsharded_faults_shed_or_serve_bit_exact():
    """A high error rate on one unreplicated verbs path: every request
    the run serves has the fault-free tokens; a request whose paging op
    stays failed is shed with a typed reason, never a crash."""
    base = ["--smoke", "--requests", "4", "--max-new", "3", "--slots",
            "2", "--prompt-len", "5", "--access-path", "verbs",
            "--device", "cpu"]
    plain = port_serve.main(base)
    got = port_serve.main(base + ["--fault-seed", "3", "--fault-rate",
                                  "0.4", "--fault-timeout-rate", "0.1"])
    assert got["undrained"] == 0
    for rid, toks in got["outputs"].items():
        assert toks == plain["outputs"][rid]
    assert got["shed"] == got["rejected"]["count"] == \
        len(got["faults"]["failed_reasons"])
    assert got["requests"] + got["shed"] == 4
    assert got["faults"]["retry"]["retries"] > 0


# ---------------------------------------------------------------------------
# the fabric's integrity plane, scrub and flap, on both packages
# ---------------------------------------------------------------------------

def _fabrics(**kw):
    from repro.access import create_path as ref_path
    from repro.faults.retry import RetryPolicy as RefRetry
    from repro_torch.access import create_path as port_path
    from repro_torch.faults.retry import RetryPolicy as PortRetry
    common = dict(member="xdma", shards=3, replicas=2, n_pages=8,
                  page_bytes=64, n_channels=1, integrity=True)
    common.update(kw)
    return (ref_path("fabric", retry=RefRetry(base_s=0.0), **common),
            port_path("fabric", retry=PortRetry(base_s=0.0),
                      device="cpu", **common))


def _page_vals(n, nbytes, seed):
    rng = np.random.default_rng(seed)
    return {p: rng.integers(0, 256, nbytes, np.uint8) for p in range(n)}


def test_corrupt_primary_falls_back_to_replica():
    ref, port = _fabrics()
    with ref, port:
        vals = _page_vals(8, 64, 4)
        stats = []
        for fab in (ref, port):
            for p, v in vals.items():
                fab.write(p, v)
            fab.member(fab.ring.owners(0)[0]).backend.mem[0, 3] ^= 0xFF
            np.testing.assert_array_equal(fab.read(0), vals[0])
            np.testing.assert_array_equal(fab.read_many([0, 1])[0],
                                          vals[0])
            s = fab.stats()
            stats.append((s["integrity_failures"], s["failovers"]))
        assert stats[1] == stats[0] and stats[1][0] >= 1


def test_scrub_repairs_a_corrupted_replica_like_the_reference():
    from repro.fabric import FabricManager as RefManager
    from repro_torch.fabric import FabricManager as PortManager
    ref, port = _fabrics()
    with ref, port:
        vals = _page_vals(8, 64, 5)
        outs = []
        for fab, Mgr in ((ref, RefManager), (port, PortManager)):
            mgr = Mgr(fab)
            for p, v in vals.items():
                fab.write(p, v)
            bad = fab.ring.owners(2)[1]
            fab.member(bad).backend.mem[2, 7] ^= 0x10
            first, again = mgr.scrub(), mgr.scrub()
            assert fab.checksums.check(2, fab.member(bad).backend.mem[2])
            outs.append((first, again))
        assert outs[1] == outs[0]
        assert outs[1][0]["repaired"] >= 1 and outs[1][1]["repaired"] == 0
    ref, port = _fabrics(integrity=False)
    with ref, port:
        assert PortManager(port).scrub() == RefManager(ref).scrub()


def test_flap_down_up_down_through_the_manager():
    """Repeated flap of one member in both packages: the same epochs,
    repairs and recoveries, and every read bit-exact throughout."""
    from repro.fabric import FabricManager as RefManager
    from repro_torch.fabric import FabricManager as PortManager
    ref, port = _fabrics(n_pages=16)
    with ref, port:
        vals = _page_vals(16, 64, 6)
        logs = []
        for fab, Mgr in ((ref, RefManager), (port, PortManager)):
            mgr = Mgr(fab)
            for p, v in vals.items():
                fab.write(p, v)
            victim = fab.alive_members()[-1]
            log = []
            for op in ("fail", "fail", "recover", "recover", "fail"):
                call = mgr.fail_node if op == "fail" else mgr.recover_node
                r = call(victim)
                log.append((op, bool(r.get("noop")), r["copies_executed"],
                            fab.epoch))
                for p, v in vals.items():
                    np.testing.assert_array_equal(fab.read(p), v)
            logs.append(log)
        assert logs[1] == logs[0]
        epochs = [0] + [e for *_, e in logs[1]]
        assert epochs == sorted(epochs) and len(set(epochs)) == 4


def test_injected_flap_window_heals_via_replicas():
    ref, port = _fabrics()
    with ref, port:
        vals = _page_vals(8, 64, 7)
        counts = []
        for fab, inj in ((ref, ref_inj), (port, port_inj)):
            for p, v in vals.items():
                fab.write(p, v)
            scope = fab.member(fab.alive_members()[-1]).backend.fault_scope
            plan = inj.install(inj.FaultPlan(0, flaps={scope: [(0, 10)]}))
            try:
                for p, v in vals.items():
                    np.testing.assert_array_equal(fab.read(p), v)
            finally:
                inj.uninstall()
            counts.append((plan.counters["flap_rejections"],
                           fab.stats()["failovers"]))
        assert counts[1] == counts[0] and counts[1][0] > 0


def test_corrupted_row_never_reaches_the_device():
    """A tier store over an integrity-checked fabric: a replica whose
    stored bytes were flipped is verified on the host before the H2D,
    so the staged group row handed to the install holds the written
    bytes."""
    from repro_torch.access import create_path
    from repro_torch.faults.retry import RetryPolicy
    from repro_torch.rmem import TieredStore
    vals = _page_vals(4, 256, 8)
    fab = create_path("fabric", member="xdma", shards=3, replicas=2,
                      n_pages=4, page_bytes=256, n_channels=1,
                      retry=RetryPolicy(base_s=0.0), integrity=True,
                      device="cpu")
    # the store leaves verification to the fabric's checksum plane
    with TieredStore(4, (256,), dtype="uint8", n_hot_slots=4, path=fab,
                     integrity=True) as st:
        assert st.checksums is None
        for p, v in vals.items():
            st.write_page(p, v)
        for p in vals:
            for n in fab.ring.owners(p)[:1]:
                fab.member(n).backend.mem[p, 5] ^= 0x01
        st.prefetch(list(vals))
        packed = st.ensure_packed(list(vals))
        for p, v in vals.items():
            buf, row = packed[p]
            np.testing.assert_array_equal(buf[row].numpy(), v)
        assert fab.stats()["integrity_failures"] >= len(vals)
    fab.close()
