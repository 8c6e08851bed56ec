"""The ported qwen2-0.5b model against the reference: smoke size, float32
on both sides, the reference's params carried across by ``interop``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

LOGIT_TOL = 1e-4
MAX_LEN = 32


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(3))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, pcfg, params, pparams


def test_param_tree_matches_reference(pair):
    cfg, pcfg, params, pparams = pair
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    port = interop.tree_leaves(pparams)
    assert len(ref) == len(port)
    for (path, r), p in zip(ref, port):
        assert tuple(r.shape) == tuple(p.shape), path
        assert interop.dtype_name(p) == np.dtype(r.dtype).name, path
    shapes = [tuple(d.shape) for d in interop.tree_leaves(
        PT.param_defs(pcfg))]
    assert shapes == [tuple(r.shape) for _, r in ref]


@pytest.mark.parametrize("arch,batch,max_len,smoke", [
    ("qwen2-0.5b", 1, MAX_LEN, True),
    ("qwen2-0.5b", 4, 128, False),       # the served layout, full width
])
def test_init_cache_matches_reference(arch, batch, max_len, smoke):
    cfg, pcfg = get_config(arch), port_config(arch)
    if smoke:
        cfg, pcfg = reduce_for_smoke(cfg), port_reduce(pcfg)
    ref = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: T.init_cache(cfg, batch, max_len)))[0]
    port, _ = interop.tree_flatten(PT.init_cache(pcfg, batch, max_len,
                                                 "meta"))
    assert [jax.tree_util.keystr(p) for p, _ in ref] == [
        "['groups']['b0']['attn']['k']", "['groups']['b0']['attn']['len']",
        "['groups']['b0']['attn']['v']"]
    assert [(tuple(r.shape), np.dtype(r.dtype).name) for _, r in ref] == \
        [(tuple(p.shape), interop.dtype_name(p)) for p in port]


def test_prefill_decode_logits_and_greedy_tokens(pair):
    cfg, pcfg, params, pparams = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(1, 11)).astype(np.int32)
    prefill = jax.jit(lm.make_prefill_step(cfg))
    decode = jax.jit(lm.make_decode_step(cfg))
    jc, jl = prefill(params, {"tokens": jnp.asarray(toks)},
                     T.init_cache(cfg, 1, MAX_LEN))
    tc, tl = plm.make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks)},
        PT.init_cache(pcfg, 1, MAX_LEN, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jt, tt = [int(jnp.argmax(jl[0]))], [int(torch.argmax(tl[0]))]
    pdecode = plm.make_decode_step(pcfg)
    for i in range(7):
        pos = np.array([[toks.shape[1] + i]], np.int32)
        jc, jl = decode(params, {"tokens": jnp.asarray([[jt[-1]]],
                                                       jnp.int32),
                                 "pos": jnp.asarray(pos)}, jc)
        tc, tl = pdecode(pparams, {"tokens": torch.tensor(
            [[tt[-1]]], dtype=torch.int32), "pos": torch.from_numpy(pos)},
            tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jt.append(int(jnp.argmax(jl[0])))
        tt.append(int(plm.greedy_sample(tl)[0]))
    assert tt == jt and len(tt) == 8
    for r, p in zip(jax.tree.leaves(jc), interop.tree_leaves(tc)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_port_init_follows_reference_rules():
    """Own init on the device: the reference's rules, torch's numbers.
    Zero biases and norm scales, embedding std 0.02, and std = fan^-1/2
    with the fan taken from the *stacked* def as the reference takes it
    (``normal_in``: the leading layer axis; ``normal``: every axis but
    the last)."""
    cfg = reduce_for_smoke(get_config("qwen2-0.5b"))
    pcfg = port_reduce(port_config("qwen2-0.5b"))
    p = PT.tree_init(PT.param_defs(pcfg), pcfg, 0, "cpu")
    ref = jax.tree.leaves(T.tree_init(T.param_defs(cfg), cfg,
                                      jax.random.PRNGKey(0)))
    for r, t in zip(ref, interop.tree_leaves(p)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == r.shape
        rs, ts = float(np.std(np.asarray(r, np.float32))), \
            float(t.float().std())
        assert abs(ts - rs) <= 0.1 * rs + 1e-6, (r.shape, rs, ts)
    a = p["groups"]["b0"]["attn"]
    assert float(a["bq"].float().abs().max()) == 0.0
    assert float(p["final_ln"].float().abs().max()) == 0.0
    again = PT.tree_init(PT.param_defs(pcfg), pcfg, 0, "cpu")
    assert torch.equal(again["emb"], p["emb"])
