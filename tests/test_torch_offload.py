"""The port's host-offloaded optimizer against the reference's: the
params after several streamed steps, the host moments (float32 and bf16,
bit for bit where the math is the same), the bytes the engine moves a
step (H2C then C2H of every moment: twice ``host_bytes``), the leaf
pipeline's overlap, and the deprecated ``KVPager`` alias.  Float32,
2e-5 per op."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.offload import HostOffloadedOptimizer as RefOffload  # noqa
from repro.optim.adamw import AdamW as RefAdamW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import HostOffloadedOptimizer, KVPager  # noqa: E402
from repro_torch.core.engine import MemoryEngine  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

TOL = 2e-5


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w": f(32, 16), "g": {"ln": f(3, 16), "b": f(16)}, "s": f()}


def _both(tree, dtype="float32"):
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    return jt, interop.tree_to_torch(jax.tree.map(np.asarray, jt))


@pytest.mark.parametrize("state_dtype,param_dtype",
                         [("float32", "float32"), ("bfloat16", "float32"),
                          ("float32", "bfloat16")])
def test_streamed_steps_match_reference(state_dtype, param_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=10,
              state_dtype=state_dtype)
    jp, pp = _both(_tree(0), param_dtype)
    ref = RefOffload(RefAdamW(**kw), jp)
    port = HostOffloadedOptimizer(AdamW(**kw), pp, device="cpu")
    try:
        assert port.host_bytes() == sum(
            l.nbytes for l in jax.tree.leaves(ref.host_state))
        for i in range(3):
            jg, pg = _both(_tree(10 + i), param_dtype)
            before = port.engine.stats()["bytes_moved"]
            jp = ref.step(jp, jg, jnp.asarray(i, jnp.int32))
            pp = port.step(pp, pg, torch.tensor(i, dtype=torch.int32))
            assert port.engine.stats()["bytes_moved"] - before == \
                2 * port.host_bytes()
        tol = TOL if "bfloat16" not in (state_dtype, param_dtype) else 1e-2
        for a, b in zip(interop.tree_leaves(pp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       atol=tol, rtol=tol)
        for key in ("m", "v"):
            for a, b in zip(interop.tree_leaves(port.host_state[key]),
                            jax.tree.leaves(ref.host_state[key])):
                assert a.device.type == "cpu"
                assert interop.dtype_name(a) == jnp.dtype(b.dtype).name
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           atol=tol, rtol=tol)
    finally:
        port.close()


def test_the_next_leaf_is_in_flight_while_one_updates(monkeypatch):
    """While leaf i updates, the H2C of leaf i+1 has been submitted."""
    _, pp = _both(_tree(1))
    opt = AdamW(lr=1e-3)
    port = HostOffloadedOptimizer(opt, pp, device="cpu")
    log = []
    real_write, real_update = port.engine.write, port._leaf_update

    def write(arr, **kw):
        log.append("h2c")
        return real_write(arr, **kw)

    def update(*a):
        log.append("update")
        return real_update(*a)
    monkeypatch.setattr(port.engine, "write", write)
    monkeypatch.setattr(port, "_leaf_update", update)
    _, pg = _both(_tree(2))
    port.step(pp, pg, torch.zeros((), dtype=torch.int32))
    port.close()
    n = len(interop.tree_leaves(pp))
    assert log == ["h2c", "h2c"] + ["h2c", "h2c", "update"] * (n - 1) + \
        ["update"]


def test_engine_handed_in_and_default_device():
    _, pp = _both(_tree(3))
    eng = MemoryEngine(n_channels=2, path="qdma", device="cpu")
    port = HostOffloadedOptimizer(AdamW(), pp, engine=eng)
    assert port.engine is eng and eng.flavor == "qdma"
    port.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HostOffloadedOptimizer(AdamW(), pp)


def test_kvpager_is_a_deprecated_tiered_store():
    """The store with the ``n_hbm_slots`` spelling; ``host`` is the typed
    view of a local-host cold tier and raises over an access path, as in
    the reference."""
    eng = MemoryEngine(n_channels=1, path="xdma", device="cpu")
    with pytest.warns(DeprecationWarning, match="TieredStore"):
        pager = KVPager(8, (4, 16), n_hbm_slots=2, engine=eng)
    try:
        assert pager.n_hbm_slots == pager.n_hot_slots == 2
        page = np.arange(64, dtype=np.float32).reshape(4, 16)
        pager.write_page(3, page)
        assert pager.host.shape == (8, 4, 16)
        assert pager.host[3].tobytes() == page.tobytes()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = pager.ensure([3])
        assert out is not None
    finally:
        pager.close()
        eng.close()
    with pytest.warns(DeprecationWarning):
        over_path = KVPager(8, (4, 16), path="xdma", device="cpu")
    try:
        with pytest.raises(AttributeError, match="LocalHostBackend"):
            over_path.host
    finally:
        over_path.close()


# ---------------------------------------------------------------------------
# the Table 1 benchmark twin and the offload example
# ---------------------------------------------------------------------------

def _row_names(out):
    return [l.split(",")[0] for l in out.splitlines()
            if l.startswith(("tab1_", "e2e_", "roofline_"))]


def test_offload_step_rows_are_the_reference_rows(capsys):
    from benchmarks import offload_step as ref_bench
    from repro_torch.benchmarks import offload_step as port_bench
    ref_bench.run(quick=True)
    want = capsys.readouterr().out
    res = port_bench.run(quick=True, device="cpu")
    got = capsys.readouterr().out
    assert _row_names(got) == _row_names(want) == [
        "tab1_step_device_optimizer", "tab1_step_offloaded_optimizer",
        "tab1_kv_pager_ensure4"]
    # the same host bytes and page size in the derived columns
    assert got.split("host_bytes=")[1].split("MB")[0] == \
        want.split("host_bytes=")[1].split("MB")[0]
    assert "page=16KB" in got and "page=16KB" in want
    assert res["host_bytes"] > 0


def test_offload_demo_runs_on_the_cpu(capsys):
    from repro_torch.examples import offload_demo
    res = offload_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "== host-offloaded AdamW ==" in out
    assert res["offload"]["host_bytes"] == 8 * 256 * 256 * 8
    assert res["kv"]["h2c_bytes"] > 0
    assert [r["channels"] for r in res["bw"]] == [1, 1, 4, 4]
