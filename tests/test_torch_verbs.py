"""The port's far-memory tier against the reference's: one-sided verbs
(the same doorbell sequence gives the same bytes, work completions and
node counters, ``staged_hops`` and ``coalesced_runs`` included), the
address map's routing, and ``RemoteBackend``'s page round trip and
stats."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.channels import CompletionMode as RefMode  # noqa: E402
from repro.rmem import backend as ref_backend  # noqa: E402
from repro.rmem import node as ref_node  # noqa: E402
from repro.rmem import verbs as ref_verbs  # noqa: E402
from repro_torch.core.channels import CompletionMode  # noqa: E402
from repro_torch.rmem import backend as port_backend  # noqa: E402
from repro_torch.rmem import node as port_node  # noqa: E402
from repro_torch.rmem import verbs as port_verbs  # noqa: E402

REF = (ref_verbs, ref_node, {})
PORT = (port_verbs, port_node, {"device": "cpu"})


def _drive(pkg, n_nodes, mode="polled"):
    """One doorbell sequence: three writes (an auto-rung doorbell, one
    coalesced run), a mixed read/write/read doorbell (three runs of one),
    three reads (one coalesced run), then a synchronous write and read;
    over one node or an address map striping two."""
    verbs, node_mod, kw = pkg
    nodes = [node_mod.MemoryNode(f"n{i}", 8192, **kw)
             for i in range(n_nodes)]
    target = nodes[0] if n_nodes == 1 else \
        node_mod.AddressMap.striped(nodes, 12000, align=64)
    rng = np.random.default_rng(11)
    buf = rng.integers(0, 256, 6000, dtype=np.uint8)
    mr = verbs.MemoryRegion(buf)
    seen = []
    modes = {"polled": (CompletionMode.POLLED, RefMode.POLLED),
             "interrupt": (CompletionMode.INTERRUPT, RefMode.INTERRUPT)}
    m = modes[mode][0 if verbs is port_verbs else 1]
    cq = verbs.CompletionQueue(m, on_completion=seen.append)
    qp = verbs.QueuePair(target, cq, doorbell_batch=3)
    # spans cross the 6000-byte stripe boundary on two nodes
    for i in range(3):
        qp.post_write(mr, 1000 * i, 5000 + 700 * i, 900)
    qp.post_read(mr, 3000, 5000, 500)
    qp.post_write(mr, 4000, 200, 300, signaled=True)
    qp.post_read(mr, 4500, 5900, 400)
    qp.flush()
    for i in range(3):
        qp.post_read(mr, 100 * i, 5200 + 100 * i, 64)
    qp.ring_doorbell()
    qp.flush()
    qp.write(mr, 5000, 7000, 1000)
    qp.read(mr, 5500, 7100, 300)
    qp.flush()
    wcs = seen if m.value == "interrupt" else cq.poll(256)
    comps = sorted((w.wr_id, w.opcode.value, w.status.value, w.nbytes,
                    w.batch_bytes, w.batch_wrs) for w in wcs)
    pools = [n.pool.copy() for n in nodes]
    stats = [n.stats() for n in nodes]
    out = {"mr": buf.copy(), "pools": pools, "completions": comps,
           "nodes": stats, "qp": qp.stats()}
    qp.close()
    cq.close()
    for n in nodes:
        n.close()
    return out


@pytest.mark.parametrize("n_nodes", [1, 2])
@pytest.mark.parametrize("mode", ["polled", "interrupt"])
def test_doorbell_sequence_matches_reference(n_nodes, mode):
    want = _drive(REF, n_nodes, mode)
    got = _drive(PORT, n_nodes, mode)
    np.testing.assert_array_equal(got["mr"], want["mr"])
    for g, w in zip(got["pools"], want["pools"]):
        np.testing.assert_array_equal(g, w)
    assert got["completions"] == want["completions"]
    assert got["nodes"] == want["nodes"]
    assert got["qp"] == want["qp"]
    # the doorbell amortization the reference counts: one hop a run
    total = {k: sum(s[k] for s in got["nodes"])
             for k in ("staged_hops", "coalesced_runs", "ops")}
    assert total["coalesced_runs"] >= 2
    assert total["staged_hops"] < total["ops"]


def test_address_map_routing_matches_reference():
    pkgs = {"ref": REF, "port": PORT}
    nodes = {k: [p[1].MemoryNode(f"m{i}", 4096, **p[2]) for i in range(3)]
             for k, p in pkgs.items()}
    maps = {k: pkgs[k][1].AddressMap.striped(ns, 10000, align=64)
            for k, ns in nodes.items()}
    for addr, n in [(0, 10), (3300, 200), (3000, 7000), (6600, 1)]:
        routed = {k: [(nd.name, phys, nb, off) for nd, phys, nb, off in
                      m.resolve(addr, n)] for k, m in maps.items()}
        assert routed["port"] == routed["ref"]
    for k, ns in nodes.items():
        with pytest.raises(ValueError, match="unmapped"):
            maps[k].resolve(9990, 20)
        for nd in ns:
            nd.close()


def test_node_hop_on_the_cpu_and_errors():
    node = port_node.MemoryNode("n", 1024, device="cpu")
    assert node.device.type == "cpu" and node.stream is None
    mr = port_verbs.MemoryRegion(np.arange(256, dtype=np.uint8))
    qp = port_verbs.QueuePair(node, doorbell_batch=1)
    qp.write(mr, 0, 100, 256)
    np.testing.assert_array_equal(node.pool[100:356], np.arange(256))
    qp.post_write(mr, 0, 1000, 100)            # runs off the pool
    with pytest.raises(IndexError, match="out of pool"):
        qp.flush()
    with pytest.raises(ValueError, match="out of bounds"):
        qp.post_read(mr, 200, 0, 100)
    qp.close()
    node.close()
    with pytest.raises(RuntimeError, match="closed"):
        node.execute([], None)


def _remote_round_trip(mod, kw):
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 256, (6, 300), dtype=np.uint8)
    be = mod.RemoteBackend(6, 300, n_nodes=2, doorbell_batch=2, **kw)
    be.store(0, vals[0])
    be.store_many([1, 2, 3], list(vals[1:4]))
    be.store_many_async([4, 5], list(vals[4:])).wait()
    out = {"one": be.load(2), "many": be.load_many([5, 0, 3]),
           "async": be.load_many_async([1, 4]).wait()}
    be.flush()
    st = be.stats()
    be.close()
    return vals, out, st


def test_remote_backend_round_trip_matches_reference():
    vals, want, ws = _remote_round_trip(ref_backend, {})
    _, got, gs = _remote_round_trip(port_backend, {"device": "cpu"})
    np.testing.assert_array_equal(got["one"], vals[2])
    np.testing.assert_array_equal(got["many"], vals[[5, 0, 3]])
    np.testing.assert_array_equal(got["async"], vals[[1, 4]])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert set(gs) == set(ws)
    # far_memory_path keeps the reference's constants: equal projections
    for k in set(ws) - {"seconds_busy"}:
        assert gs[k] == pytest.approx(ws[k]) if k == "projected_s" \
            else gs[k] == ws[k], k


def test_make_backend_and_models():
    be = port_backend.make_backend("remote", 2, 64, device="cpu")
    assert isinstance(be, port_backend.RemoteBackend)
    assert be.path_model().link_gbps == 12.5
    be.close()
    assert isinstance(port_backend.make_backend("local", 2, 64),
                      port_backend.LocalHostBackend)
    with pytest.raises(ValueError, match="unknown tier backend"):
        port_backend.make_backend("tape", 1, 1)
