"""The ported recurrentgemma-2b (RG-LRU + local attention) against the
reference: smoke size, float32 on both sides, the reference's params
carried across by ``interop``.  Prompts of 40 tokens overrun the smoke
window of 32, so the ring cache's roll and wrap run too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import rglru as PRG  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "recurrentgemma-2b"
LOGIT_TOL = 1e-4
OP_TOL = 2e-5
MAX_LEN = 64
PROMPT = 40
N_REQ, MAX_NEW, SLOTS = 6, 8, 4


def _cfgs(n_layers=None):
    """Smoke configs in float32; ``n_layers`` 8 gives 2 groups + a tail
    of 2 "rec" layers (the full config's 8 groups + 2)."""
    extra = {"dtype": "float32"}
    if n_layers is not None:
        extra["n_layers"] = n_layers
    return (dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **extra),
            dataclasses.replace(port_reduce(port_config(ARCH)), **extra))


def _params(cfg, seed):
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(seed))
    return params, interop.tree_to_torch(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=[None, 8], ids=["groups", "tail"])
def pair(request):
    cfg, pcfg = _cfgs(request.param)
    return (cfg, pcfg) + _params(cfg, 3)


def _paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_paths(tree[k], prefix + f"['{k}']")]
    return [(prefix, tuple(tree.shape), interop.dtype_name(tree))]


@pytest.mark.parametrize("smoke,n_layers,batch,max_len", [
    (True, None, 1, MAX_LEN), (True, 8, 3, 24),
    (False, None, 4, 2304),            # the served layout, full width
])
def test_param_and_cache_trees_match_reference(smoke, n_layers, batch,
                                               max_len):
    cfg, pcfg = get_config(ARCH), port_config(ARCH)
    if smoke:
        cfg, pcfg = _cfgs(n_layers)
    ref_p = jax.eval_shape(lambda: T.tree_init(
        T.param_defs(cfg), cfg, jax.random.PRNGKey(0)))
    port_p = interop.tree_map(
        lambda d: torch.empty(d.shape, dtype=interop.torch_dtype(
            d.dtype or pcfg.dtype), device="meta"), PT.param_defs(pcfg))
    assert _port_paths(port_p) == _paths(ref_p)
    ref_c = jax.eval_shape(lambda: T.init_cache(cfg, batch, max_len))
    port_c = PT.init_cache(pcfg, batch, max_len, "meta")
    assert _port_paths(port_c) == _paths(ref_c)
    names = [n for n, _, _ in _paths(ref_c)]
    assert "['groups']['b2']['attn']['k']" in names
    assert "['groups']['b0']['rec']['h']" in names
    if not smoke:
        # the window caps the ring cache: 2048 rows at max_len 2304
        k = dict((n, s) for n, s, _ in _paths(ref_c))
        assert k["['groups']['b2']['attn']['k']"] == (8, 4, 2048, 1, 256)
        assert "['tail']['t1']['rec']['conv']" in k


def _rec_params(cfg, rng):
    W, D, K = cfg.rglru.width, cfg.d_model, cfg.rglru.conv_width
    p = {"wx": rng.standard_normal((D, W)) * D ** -0.5,
         "wg": rng.standard_normal((D, W)) * D ** -0.5,
         "conv": rng.standard_normal((K, W)) * 0.3,
         "conv_b": rng.standard_normal((W,)) * 0.1,
         "wa": rng.standard_normal((W, W)) * W ** -0.5,
         "wb": rng.standard_normal((W, W)) * W ** -0.5,
         "lam": rng.uniform(-9.0, -4.3, (W,)),
         "wo": rng.standard_normal((W, D)) * W ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, tol=OP_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_rglru_apply_prefill_then_decode_with_state_carry():
    cfg, pcfg = _cfgs()
    rng = np.random.default_rng(0)
    jp, tp = _rec_params(cfg, rng)
    B = 2
    x = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    jo, js = RG.rglru_apply(cfg, jp, jnp.asarray(x), mode="prefill")
    to, ts = PRG.rglru_apply(pcfg, tp, torch.from_numpy(x), mode="prefill")
    _close(to, jo)
    for k in ("h", "conv"):
        _close(ts[k], js[k])
    # a second prefill chunk that starts from the carried state
    x2 = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    jo, js = RG.rglru_apply(cfg, jp, jnp.asarray(x2), mode="prefill",
                            state=js)
    to, ts = PRG.rglru_apply(pcfg, tp, torch.from_numpy(x2), mode="prefill",
                             state=ts)
    _close(to, jo)
    for step in range(4):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, js = RG.rglru_apply(cfg, jp, jnp.asarray(xd), mode="decode",
                                state=js)
        to, ts = PRG.rglru_apply(pcfg, tp, torch.from_numpy(xd),
                                 mode="decode", state=ts)
        _close(to, jo)
        for k in ("h", "conv"):
            _close(ts[k], js[k])
        assert ts["h"].dtype == torch.float32


def test_prefill_decode_logits_and_greedy_tokens(pair):
    cfg, pcfg, params, pparams = pair
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(1, PROMPT)).astype(np.int32)
    jc, jl = jax.jit(lm.make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(toks)}, T.init_cache(cfg, 1, MAX_LEN))
    tc, tl = plm.make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks)},
        PT.init_cache(pcfg, 1, MAX_LEN, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    decode = jax.jit(lm.make_decode_step(cfg))
    pdecode = plm.make_decode_step(pcfg)
    jt, tt = [int(jnp.argmax(jl[0]))], [int(torch.argmax(tl[0]))]
    for i in range(8):
        pos = np.array([[PROMPT + i]], np.int32)
        jc, jl = decode(params, {"tokens": jnp.asarray([[jt[-1]]], jnp.int32),
                                 "pos": jnp.asarray(pos)}, jc)
        tc, tl = pdecode(pparams, {"tokens": torch.tensor(
            [[tt[-1]]], dtype=torch.int32), "pos": torch.from_numpy(pos)},
            tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        jt.append(int(jnp.argmax(jl[0])))
        tt.append(int(plm.greedy_sample(tl)[0]))
    assert tt == jt and len(tt) == 9
    # the caches at the logits' bar, relative to each leaf's scale: K/V
    # entries reach ~15 under the reference's stacked-fan init, so a
    # plain absolute 1e-4 would be a 1e-5 relative bar
    for (path, r), p in zip(jax.tree_util.tree_flatten_with_path(jc)[0],
                            interop.tree_leaves(tc)):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(
            p.float().numpy(), r, rtol=LOGIT_TOL,
            atol=LOGIT_TOL * max(1.0, float(np.abs(r).max())),
            err_msg=jax.tree_util.keystr(path))


def test_port_init_follows_reference_rules():
    """The "small" (std 0.01) and "lru_lambda" (uniform on [-9, -4.3])
    inits of the rec block, beside the rules the dense slice ported."""
    cfg, pcfg = reduce_for_smoke(get_config(ARCH)), port_reduce(
        port_config(ARCH))
    p = PT.tree_init(PT.param_defs(pcfg), pcfg, 0, "cpu")
    ref = jax.tree.leaves(T.tree_init(T.param_defs(cfg), cfg,
                                      jax.random.PRNGKey(0)))
    for r, t in zip(ref, interop.tree_leaves(p)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == r.shape
        rs, ts = float(np.std(np.asarray(r, np.float32))), \
            float(t.float().std())
        assert abs(ts - rs) <= 0.15 * rs + 1e-6, (r.shape, rs, ts)
    rec = p["groups"]["b0"]["rec"]
    lam = rec["lam"].float()
    assert -9.0 <= float(lam.min()) and float(lam.max()) <= -4.3
    assert abs(float(rec["conv"].float().std()) - 0.01) < 0.003
    assert float(rec["conv_b"].float().abs().max()) == 0.0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg, pcfg = _cfgs()
    params, pparams = _params(cfg, 1)
    rng = np.random.default_rng(7)
    # staggered lengths, most past the window of 32: slots finish and
    # refill at different steps, and the ring cache wraps in decode
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(20, 50, size=N_REQ)]
    ref = _run(RefEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                         access_path="xdma"), RefRequest, prompts)
    return cfg, pcfg, params, pparams, prompts, ref


def _run(engine, request_cls, prompts):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(rid=i, prompt=p, max_new=MAX_NEW))
    assert engine.run_until_drained() == 0
    if engine.pager is not None:
        engine.pager.close()
    return {r.rid: list(r.out_tokens) for r in engine.done}


@pytest.mark.parametrize("paging,fused,overlap", [
    (True, True, True), (True, True, False), (True, False, True),
    (True, False, False), (False, True, True),
])
def test_serve_engine_matches_reference(served, paging, fused, overlap):
    _, pcfg, _, pparams, prompts, ref = served
    eng = ServeEngine(pcfg, pparams, batch_slots=SLOTS, max_len=MAX_LEN,
                      access_path="xdma" if paging else None,
                      fused_install=fused, overlap=overlap, device="cpu")
    outs = _run(eng, Request, prompts)
    assert outs == ref
    assert max(len(p) for p in prompts) > pcfg.attention.window
    if paging:
        want = (N_REQ, 0) if fused else (0, N_REQ)
        assert (eng.install_fused, eng.install_fallback) == want


@pytest.mark.parametrize("extra", [
    ["--kv-paging"], [], ["--kv-paging", "--no-overlap"],
    ["--kv-paging", "--no-fused-install"],
])
def test_cli_matches_reference_engine(monkeypatch, extra):
    """``serve.main(--device cpu)`` with the reference's float32 weights
    (its own init swapped for them) serves the reference engine's tokens
    for the CLI's seeded prompts."""
    cfg, pcfg = _cfgs()
    params, pparams = _params(cfg, 0)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    n, new = 4, 6
    got = port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--prompt-len", str(PROMPT), "--max-len",
                           str(MAX_LEN), "--requests", str(n), "--max-new",
                           str(new)] + extra)
    rng = np.random.default_rng(0)
    eng = RefEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                    access_path="xdma" if extra else None)
    for r in range(n):
        eng.submit(RefRequest(rid=r, prompt=rng.integers(
            0, cfg.vocab, size=PROMPT).astype(np.int32), max_new=new))
    assert eng.run_until_drained() == 0
    if eng.pager is not None:
        eng.pager.close()
    assert got["outputs"] == {r.rid: list(r.out_tokens) for r in eng.done}
    if "--kv-paging" in extra:
        fused = "--no-fused-install" not in extra
        assert got["install"]["fused"] == (n if fused else 0)
        assert got["install"]["fallback"] == (0 if fused else n)
