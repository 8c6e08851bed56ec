"""The port's tiered store against the reference's dirty tracking: device
updates (``update_page(s)``), forced evictions, ``read_page`` and
``release(writeback=...)`` give the same bytes and the same
``c2h_bytes``, ``dirty_evictions``, ``clean_evictions`` and
``writeback_bytes_skipped`` over every access path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.rmem import TieredStore as RefStore  # noqa: E402
from repro_torch.rmem import TieredStore  # noqa: E402

PATHS = ("xdma", "qdma", "verbs", "auto")
SHAPE = (48,)
PAGE_BYTES = 48 * 4
COUNTERS = ("h2c_bytes", "c2h_bytes", "evictions", "clean_evictions",
            "dirty_evictions", "writeback_bytes_skipped", "staged_hops",
            "staged_hops_saved", "prefetch_issued", "prefetch_hits",
            "spill_bytes_logical", "spill_bytes_physical", "page_bytes",
            "phys_page_bytes", "cold_bytes_logical", "cold_bytes_physical")


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drive(cls, path, **kw):
    """Write six pages cold, update two resident pages on the device,
    evict them (dirty) and a clean one, read pages back from the slots
    and the cold tier, then release with and without write-back."""
    rng = np.random.default_rng(21)
    vals = rng.standard_normal((6,) + SHAPE).astype(np.float32)
    new = rng.standard_normal((6,) + SHAPE).astype(np.float32)
    seen = {}
    with cls(6, SHAPE, dtype="float32", n_hot_slots=2, path=path,
             n_channels=1, doorbell_batch=2, **kw) as st:
        for p in range(6):
            st.write_page(p, vals[p])
        st.ensure([0, 1])
        st.update_pages({0: new[0], 1: new[1]})
        seen["dirty_after_update"] = st.dirty_pages
        seen["resident"] = st.resident_pages
        st.ensure([2, 3])                   # evicts 0 and 1: dirty
        seen["dirty_after_evict"] = st.dirty_pages
        seen["page0"] = _host(st.ensure([0])[0])    # evicts 2: clean
        seen["read_cold_1"] = st.read_page(1)
        seen["read_slot_0"] = st.read_page(0)
        st.mark_dirty(0)
        seen["is_dirty_0"] = st.is_dirty(0)
        st.release(0)                       # dirty: written back
        seen["slot_3"] = _host(st.update_page(3, new[3]))
        st.release(3, writeback=False)      # dirty, but discarded
        seen["read_3"] = st.read_page(3)
        seen["read_0"] = st.read_page(0)
        with pytest.raises(KeyError, match="not resident"):
            st.update_pages({5: new[5]})
        with pytest.raises(KeyError, match="not resident"):
            st.mark_dirty(5)
        stats = st.stats()
    return vals, new, seen, stats


@pytest.mark.parametrize("path", PATHS)
def test_dirty_round_trip_matches_reference(path):
    vals, new, want, ws = _drive(RefStore, path)
    _, _, got, gs = _drive(TieredStore, path, device="cpu")
    for k, w in want.items():
        if isinstance(w, (list, bool)):
            assert got[k] == w, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(w), err_msg=k)
    assert got["dirty_after_update"] == [0, 1]
    assert got["dirty_after_evict"] == []
    np.testing.assert_array_equal(got["page0"], new[0])
    np.testing.assert_array_equal(got["read_cold_1"], new[1])
    np.testing.assert_array_equal(got["read_3"], vals[3])   # discarded
    np.testing.assert_array_equal(got["read_0"], new[0])
    for k in COUNTERS:
        assert gs[k] == ws[k], (k, gs[k], ws[k])
    # two dirty evictions and one dirty release drained their slots, and
    # read_page drained one resident slot: four pages of C2H
    assert gs["dirty_evictions"] == 2
    assert gs["c2h_bytes"] == 4 * PAGE_BYTES
    assert gs["clean_evictions"] == gs["evictions"] - 2
    assert gs["writeback_bytes_skipped"] == \
        gs["clean_evictions"] * PAGE_BYTES
    assert set(gs) == set(ws)
    assert set(gs["cold"]) == set(ws["cold"])


@pytest.mark.parametrize("path", ["xdma", "verbs"])
def test_clean_pages_move_no_bytes_back(path):
    with TieredStore(4, SHAPE, dtype="float32", n_hot_slots=1, path=path,
                     n_channels=1, device="cpu") as st:
        for p in range(4):
            st.write_page(p, np.full(SHAPE, p, np.float32))
        for p in range(4):
            assert float(st.ensure([p])[p][0]) == p
        st.release(3, writeback=True)
        s = st.stats()
        assert s["c2h_bytes"] == 0 and s["dirty_evictions"] == 0
        assert s["clean_evictions"] == s["evictions"] == 3
        assert s["writeback_bytes_skipped"] == 3 * PAGE_BYTES


def test_fetch_groups_follow_the_doorbell_depth():
    """A verbs-backed store loads a miss set in doorbell-depth groups, as
    the reference does; the host tier takes it whole."""
    for path, batches in (("verbs", 3), ("xdma", 1)):
        with TieredStore(6, SHAPE, dtype="float32", n_hot_slots=6,
                         path=path, n_channels=1, doorbell_batch=2,
                         device="cpu") as st, \
                RefStore(6, SHAPE, dtype="float32", n_hot_slots=6,
                         path=path, n_channels=1, doorbell_batch=2) as rs:
            for s in (st, rs):
                for p in range(6):
                    s.write_page(p, np.full(SHAPE, p, np.float32))
                s.ensure(list(range(6)))
            got, want = st.stats()["cold"], rs.stats()["cold"]
            assert got["load_batches"] == want["load_batches"] == batches
