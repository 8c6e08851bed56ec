"""The port's optimizer, gradient compression and elastic planner
against the reference: ``AdamW`` (schedule, fp32 and bf16 moments,
master weights, the stacked-norm decay rule, ``for_arch``), the
compression codes byte for byte, and ``plan_resize`` over a grid.
Float32 on both sides, 2e-5 per op."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro.runtime import elastic as RE  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import compression as PC  # noqa: E402
from repro_torch.runtime import elastic as PE  # noqa: E402

TOL = 2e-5


def _tree(seed=0, dtype=np.float32):
    """A param-like tree: a stacked (n_groups, D) norm scale, a stacked
    matrix, a 1-D final norm and a 0-d leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"groups": {"ln": f(3, 8), "w": f(3, 8, 4)}, "final_ln": f(8),
            "emb": f(16, 8), "scalar": f()}


def _both(tree, dtype="float32"):
    jt = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    pt = interop.tree_to_torch(jax.tree.map(np.asarray, jt))
    return jt, pt


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        got = got.float()
        want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol, rtol=tol)


def test_schedule_matches_reference():
    for kw in ({"warmup_steps": 10, "decay_steps": 100},
               {"warmup_steps": 1, "decay_steps": 1, "min_lr_frac": 0.3},
               {"lr": 3e-3, "warmup_steps": 5, "decay_steps": 20}):
        ref, port = RA.AdamW(**kw), PA.AdamW(**kw)
        for s in (0, 1, 4, 9, 10, 11, 50, 99, 100, 1000):
            got = port.schedule(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, ref.schedule(jnp.asarray(s, jnp.int32)))


@pytest.mark.parametrize("opts", [
    {}, {"state_dtype": "bfloat16"}, {"master_weights": True},
    {"state_dtype": "bfloat16", "master_weights": True},
    {"weight_decay": 0.0, "b2": 0.999}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_update_matches_reference_over_steps(opts, param_dtype):
    """Four updates with fresh gradients: params, moments (in their
    dtype) and master weights agree."""
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=8, **opts)
    ref, port = RA.AdamW(**kw), PA.AdamW(**kw)
    jp, pp = _both(_tree(0), param_dtype)
    js, ps = ref.init(jp), port.init(pp)
    assert sorted(ps) == sorted(js)
    for i in range(4):
        jg, pg = _both(_tree(10 + i), param_dtype)
        step = jnp.asarray(i, jnp.int32)
        jp, js = ref.update(jp, jg, js, step)
        pp, ps = port.update(pp, pg, ps, torch.tensor(i, dtype=torch.int32))
    # bf16 leaves may round to the neighbouring value
    tol = TOL if param_dtype == "float32" and not opts.get(
        "state_dtype") else 1e-2
    for a, b in zip(interop.tree_leaves(pp), jax.tree.leaves(jp)):
        assert str(a.dtype).endswith(param_dtype)
        _close(a, b, tol)
    for key in js:
        for a, b in zip(interop.tree_leaves(ps[key]),
                        jax.tree.leaves(js[key])):
            assert interop.dtype_name(a) == jnp.dtype(b.dtype).name
            _close(a, b, tol)


def test_decay_applies_to_stacked_norms_not_vectors():
    """Weight decay is where ``p.ndim >= 2`` on the leaf as stored: the
    stacked (n_groups, D) norm scale is decayed, the 1-D final norm and
    the 0-d leaf are not, as in the reference."""
    kw = dict(lr=0.1, weight_decay=0.5, warmup_steps=1, decay_steps=10**9)
    jp, pp = _both(_tree(1))
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else
                       np.zeros_like(v) for k, v in t.items()}
    jg, pg = _both(zeros(_tree(1)))
    ref, port = RA.AdamW(**kw), PA.AdamW(**kw)
    jn, _ = ref.update(jp, jg, ref.init(jp), jnp.zeros((), jnp.int32))
    pn, _ = port.update(pp, pg, port.init(pp),
                        torch.zeros((), dtype=torch.int32))
    for path in (("groups", "ln"), ("groups", "w"), ("emb",)):
        a, b, old = pn, jn, pp
        for k in path:
            a, b, old = a[k], b[k], old[k]
        assert not torch.equal(a, old)          # decayed
        _close(a, b)
    assert torch.equal(pn["final_ln"], pp["final_ln"])
    assert torch.equal(pn["scalar"], pp["scalar"])
    _close(pn["final_ln"], jn["final_ln"])


def test_update_leaves_its_inputs_alone():
    port = PA.AdamW(lr=0.1, master_weights=True)
    _, pp = _both(_tree(2))
    _, pg = _both(_tree(3))
    ps = port.init(pp)
    before = [t.clone() for t in interop.tree_leaves((pp, ps)[0])] + \
        [t.clone() for t in interop.tree_leaves(ps)]
    port.update(pp, pg, ps, torch.zeros((), dtype=torch.int32))
    after = interop.tree_leaves(pp) + interop.tree_leaves(ps)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_for_arch_policy():
    for arch in ("grok-1-314b", "qwen2-0.5b"):
        assert PA.for_arch(arch) == PA.AdamW(**RA.for_arch(arch).__dict__)
    assert PA.for_arch("grok-1-314b").state_dtype == "bfloat16"
    assert PA.for_arch("grok-1-314b", state_dtype="float32").state_dtype \
        == "float32"


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((32, 16)) * 3).astype(np.float32),
            "b": {"c": rng.standard_normal(40).astype(np.float32),
                  "z": np.zeros((5,), np.float32)}}


def test_ef_codes_are_byte_equal_over_steps():
    """Three rounds of error-feedback int8 coding: the codes, scales and
    residuals are the reference's, byte for byte."""
    jg0, pg0 = _both(_grads(0))
    js, ps = RC.ef_init(jg0), PC.ef_init(pg0)
    for i in range(3):
        jg, pg = _both(_grads(i))
        jq, js = RC.ef_compress(jg, js)
        pq, ps = PC.ef_compress(pg, ps)
        jleaves = jax.tree.leaves(jq)           # q, s, q, s, ...
        pleaves = [x for qs in interop.tree_leaves(pq) for x in qs]
        assert len(jleaves) == len(pleaves)
        for a, b in zip(pleaves, jleaves):
            assert interop.to_numpy(a).tobytes() == np.asarray(b).tobytes()
        for a, b in zip(interop.tree_leaves(ps.residual),
                        jax.tree.leaves(js.residual)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        for a, b in zip(interop.tree_leaves(PC.ef_decompress(pq)),
                        jax.tree.leaves(RC.ef_decompress(jq))):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_compress_for_allreduce_schemes():
    jg, pg = _both(_grads(4))
    for scheme in ("none", "bf16"):
        jw, jd, _ = RC.compress_for_allreduce(jg, scheme)
        pw, pd, _ = PC.compress_for_allreduce(pg, scheme)
        for a, b in zip(interop.tree_leaves(pd(pw)),
                        jax.tree.leaves(jd(jw))):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    pw, pd, pst = PC.compress_for_allreduce(pg, "int8_ef", PC.ef_init(pg))
    jw, jd, jst = RC.compress_for_allreduce(jg, "int8_ef", RC.ef_init(jg))
    for a, b in zip(interop.tree_leaves(pd(pw)), jax.tree.leaves(jd(jw))):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError):
        PC.compress_for_allreduce(pg, "int8_ef")
    with pytest.raises(ValueError):
        PC.compress_for_allreduce(pg, "fp4")


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def test_plan_resize_matches_reference_over_a_grid():
    n = 0
    for alive, chips, mp, gb, keep in itertools.product(
            ([0], [0, 1], [0, 2, 5], [3, 1, 4, 6], list(range(8)),
             list(range(13))), (1, 4, 8), (1, 2, 4, 8, 16), (8, 12, 64, 7),
            (True, False)):
        try:
            want = RE.plan_resize(alive, chips, mp, gb, keep)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                PE.plan_resize(alive, chips, mp, gb, keep)
            continue
        got = PE.plan_resize(alive, chips, mp, gb, keep)
        assert got.__dict__ == want.__dict__
        n += 1
    assert n > 500
    for k in range(1, 70):
        assert PE.largest_pow2_leq(k) == RE.largest_pow2_leq(k)
    with pytest.raises(ValueError, match="no alive workers"):
        PE.plan_resize([], 4, 2, 8)
