"""The other model families of the port against the reference: M-RoPE
and the vision stub (qwen2-vl-7b), MoE (qwen2-moe-a2.7b, grok-1-314b),
the audio stub (musicgen-large), RWKV (rwkv6-1.6b) and the int8 KV cache
(``kv_dtype="int8"``).  Float32 on both sides: 2e-5 per op, 1e-4 on
logits, tokens equal, int8 codes equal byte for byte."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

TOL = 2e-5
LOGIT_TOL = 1e-4
INT8 = "qwen2-0.5b+int8kv"       # qwen2-0.5b with kv_dtype="int8"
NEW = ["qwen2-moe-a2.7b", "grok-1-314b", "qwen2-vl-7b", "musicgen-large",
       "rwkv6-1.6b", INT8]


def _get(arch, port: bool, smoke: bool = True, **extra):
    name = "qwen2-0.5b" if arch == INT8 else arch
    cfg = (port_config if port else get_config)(name)
    if smoke:
        cfg = (port_reduce if port else reduce_for_smoke)(cfg)
    if arch == INT8:
        extra["kv_dtype"] = "int8"
    return dataclasses.replace(cfg, **extra) if extra else cfg


def _pair(arch, seed=3):
    cfg = _get(arch, False, dtype="float32")
    pcfg = _get(arch, True, dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(seed))
    return cfg, pcfg, params, interop.tree_to_torch(
        jax.tree.map(np.asarray, params))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# M-RoPE, the vision stub, the int8 KV cache
# ---------------------------------------------------------------------------

def test_mrope_rotates_each_band_by_its_own_stream():
    """Three different (t, h, w) streams: qwen2-vl's sections 16/24/24
    of 64 rotary pairs, and a smoke head whose sections overrun it (the
    band index is clipped to 2)."""
    rng = np.random.default_rng(0)
    for dh, sections in ((128, (16, 24, 24)), (16, (2, 3, 9))):
        x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
        pos = np.stack([rng.integers(0, 50, (2, 7)),
                        rng.integers(0, 9, (2, 7)),
                        rng.integers(100, 200, (2, 7))], -1).astype(np.int32)
        want = L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
        got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sections)
        _close(got, want)
        # one stream alone moves its own band only
        pos2 = pos.copy()
        pos2[..., 1] += 5
        moved = (PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos2),
                               1e6, sections) - got).abs().amax(dim=(0, 1, 2))
        lo = sections[0]
        hi = min(dh // 2, lo + sections[1])
        band = torch.zeros(dh // 2, dtype=torch.bool)
        band[lo:hi] = True
        band = torch.cat([band, band])
        assert bool((moved[~band] == 0).all()) and bool(
            (moved[band] > 0).all())


def test_vision_stub_embed_matches_reference():
    cfg, pcfg, params, pparams = _pair("qwen2-vl-7b")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    emb = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    mask = rng.random((2, 9)) < 0.5
    batch = {"tokens": toks, "vision_embeds": emb, "vision_mask": mask}
    want = lm.embed(cfg, params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    got = plm.embed(pcfg, pparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    _close(got, want)
    assert bool((got[torch.from_numpy(mask)] ==
                 torch.from_numpy(emb[mask])).all())
    # and through the whole forward, with the default positions
    lg_ref, _, _ = lm.forward(cfg, params, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                              mode="train")
    lg, _, _ = plm.forward(pcfg, pparams, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                           mode="prefill")
    _close(lg, lg_ref, LOGIT_TOL)


def test_int8_kv_quantizer_is_byte_equal():
    """``_kv_quantize`` on the same K: int8 codes and float32 scales
    equal the reference's byte for byte (round half to even, clipped to
    +-127, scale floor 1e-6), and so does the dequantisation."""
    rng = np.random.default_rng(2)
    t = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    t[0, 0] = 0.0                          # the 1e-6 scale floor
    t[1, 1, 0, :4] = [0.5, -1.5, 2.5, 127.0]
    jq, js = L._kv_quantize(jnp.asarray(t))
    tq, ts = PL._kv_quantize(torch.from_numpy(t))
    for got, want in ((tq, jq), (ts, js)):
        want = np.asarray(want)
        assert interop.to_numpy(got).dtype == want.dtype
        assert interop.to_numpy(got).tobytes() == want.tobytes()
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(L._kv_dequantize(jq, js, dt))
        got = interop.to_numpy(PL._kv_dequantize(tq, ts, tdt))
        assert got.tobytes() == want.view(got.dtype).tobytes()


def test_int8_kv_cache_prefill_and_decode_leaves():
    """kv_dtype="int8": prefill writes int8 codes and float32 scales into
    the pre-sized cache, decode scatters one quantised row per batch
    element (rows at different lengths) and attends over the dequantised
    cache.  The codes and "len" equal the reference's byte for byte; the
    scales, whose K/V come out of each package's own projection and
    RoPE, hold 2e-5, as do the outputs."""
    cfg, pcfg, params, pparams = _pair(INT8)
    jp = jax.tree.map(lambda t: t[0], params["groups"]["b0"]["attn"])
    tp = {k: v[0] for k, v in pparams["groups"]["b0"]["attn"].items()}
    rng = np.random.default_rng(2)
    B, S, Smax = 2, 6, 16
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jc = jax.tree.map(lambda t: t[0],
                      T.init_cache(cfg, B, Smax)["groups"]["b0"]["attn"])
    tc = {k: v[0] for k, v in PT.init_cache(
        pcfg, B, Smax, "cpu")["groups"]["b0"]["attn"].items()}
    assert sorted(tc) == ["k", "k_scale", "len", "v", "v_scale"]
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == \
        torch.float32

    def same(tc, jc):
        assert sorted(tc) == sorted(jc)
        for key in jc:
            want = np.asarray(jc[key])
            got = interop.to_numpy(tc[key])
            assert got.dtype == want.dtype, key
            if key.endswith("_scale"):
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
            else:
                assert got.tobytes() == want.tobytes(), key

    jo, jc = L.attention_apply(cfg, jp, jnp.asarray(x), mode="prefill",
                               pos=jnp.asarray(pos), cache=jc)
    to, tc = PL.attention_apply(pcfg, tp, torch.from_numpy(x),
                                mode="prefill", pos=torch.from_numpy(pos),
                                cache=tc)
    _close(to, jo)
    same(tc, jc)
    lens = np.array([6, 3], np.int32)
    jc["len"], tc["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(3):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pd = (lens + step)[:, None].astype(np.int32)
        jo, jc = L.attention_apply(cfg, jp, jnp.asarray(xd), mode="decode",
                                   pos=jnp.asarray(pd), cache=jc)
        to, tc = PL.attention_apply(pcfg, tp, torch.from_numpy(xd),
                                    mode="decode", pos=torch.from_numpy(pd),
                                    cache=tc)
        _close(to, jo)
        same(tc, jc)
    # without a cache, prefill returns the quantised K/V and scales
    _, jn = L.attention_apply(cfg, jp, jnp.asarray(x), mode="prefill",
                              pos=jnp.asarray(pos))
    _, tn = PL.attention_apply(pcfg, tp, torch.from_numpy(x), mode="prefill",
                               pos=torch.from_numpy(pos))
    same(tn, jn)


# ---------------------------------------------------------------------------
# param and cache trees, init rules, the MoE aux
# ---------------------------------------------------------------------------

def _paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_paths(tree[k], prefix + f"['{k}']")]
    return [(prefix, tuple(tree.shape), interop.dtype_name(tree))]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", NEW)
def test_param_and_cache_trees_match_reference(arch, smoke):
    """Leaf paths, shapes and dtypes in jax's flatten order (RWKV's cache
    is held to the reference's prefill output in test_torch_rwkv.py)."""
    cfg, pcfg = _get(arch, False, smoke), _get(arch, True, smoke)
    PL.check_supported(pcfg)
    ref = jax.eval_shape(lambda: T.tree_init(T.param_defs(cfg), cfg,
                                             jax.random.PRNGKey(0)))
    port = interop.tree_map(
        lambda d: torch.empty(d.shape, dtype=interop.torch_dtype(
            d.dtype or pcfg.dtype), device="meta"), PT.param_defs(pcfg))
    assert _port_paths(port) == _paths(ref)
    if cfg.block_pattern != ("rwkv",):
        want = _paths(jax.eval_shape(lambda: T.init_cache(cfg, 4, 128)))
        assert _port_paths(PT.init_cache(pcfg, 4, 128, "meta")) == want


@pytest.mark.parametrize("arch", [INT8, "rwkv6-1.6b"])
def test_interop_carries_the_new_cache_trees(arch):
    """The reference's prefill caches (int8 K/V beside float32 scales;
    RWKV's float32 ``S`` beside bf16 ``tm_x``/``cm_x``) cross into the
    port in jax's flatten order (uppercase ``S`` before ``tm_x``) and
    back byte for byte."""
    cfg = _get(arch, False)
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.arange(16, dtype=np.int32)[None] % cfg.vocab)
    caches, _ = lm.make_prefill_step(cfg)(params, {"tokens": toks},
                                          T.init_cache(cfg, 1, 32))
    ref = jax.tree_util.tree_flatten_with_path(caches)[0]
    port = interop.tree_to_torch(jax.tree.map(np.asarray, caches))
    assert [p for p, _, _ in _port_paths(port)] == [
        jax.tree_util.keystr(p) for p, _ in ref]
    for (_, r), t in zip(ref, interop.tree_leaves(port)):
        r = np.asarray(r)
        got = interop.to_numpy(t)
        assert got.tobytes() == r.view(got.dtype).tobytes()
    dts = {interop.dtype_name(t) for t in interop.tree_leaves(port)}
    assert dts == ({"int8", "float32", "int32"} if arch == INT8 else
                   {"float32", "bfloat16"})


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-1.6b"])
def test_port_init_follows_reference_rules(arch):
    """The rules these families add: "ones" (RWKV's ``ln_s``), "decay"
    (RWKV's ``w0``: the reference's linspace(-6, -3), equal) and
    "normal1" (the experts: fan = shape[1] of the stacked def, as the
    reference takes it), besides the stds of every other leaf."""
    cfg, pcfg = _get(arch, False), _get(arch, True)
    p = PT.tree_init(PT.param_defs(pcfg), pcfg, 0, "cpu")
    ref = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    for (path, r), t in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            interop.tree_leaves(p)):
        assert tuple(t.shape) == r.shape
        rs, ts = float(np.std(np.asarray(r, np.float32))), \
            float(t.float().std())
        assert abs(ts - rs) <= 0.1 * rs + 1e-6, (path, rs, ts)
    defs = interop.tree_leaves(PT.param_defs(pcfg))
    inits = {d.init for d in defs}
    if arch == "rwkv6-1.6b":
        assert {"ones", "decay"} <= inits
        mix = p["groups"]["b0"]["mix"]
        assert bool((mix["ln_s"] == 1).all())
        assert interop.to_numpy(mix["w0"]).tobytes() == np.asarray(
            ref["groups"]["b0"]["mix"]["w0"]).tobytes()
    else:
        assert "normal1" in inits


def test_moe_aux_is_forwards_third_value():
    """``lm.forward`` returns the blocks' summed balance loss as the
    reference's third value (0 for a dense model)."""
    cfg, pcfg, params, pparams = _pair("qwen2-moe-a2.7b")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    lg_ref, _, aux_ref = lm.forward(cfg, params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, mode="train")
    lg, _, aux = plm.forward(pcfg, pparams, {"tokens": torch.as_tensor(
        toks, dtype=torch.int32)}, mode="prefill")
    _close(lg, lg_ref, LOGIT_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=TOL,
                               atol=TOL)
    dense = _pair("musicgen-large")
    _, _, aux0 = plm.forward(dense[1], dense[3], {"tokens": torch.as_tensor(
        toks % dense[1].vocab, dtype=torch.int32)}, mode="prefill")
    assert float(aux0) == 0.0 and aux0.dtype == torch.float32


# ---------------------------------------------------------------------------
# decode against prefill, and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_prefill_and_reference(arch):
    """Prefill S tokens then decode token S: the logits equal the
    reference's doing the same (1e-4) and the port's own prefill of
    S + 1 tokens (3e-2, the reference's test_decode_matches_prefill
    bar).  The MoE archs run at capacity_factor E/K, where no
    assignment drops: a prefill's drops depend on every token routed
    with it, so S + 1 tokens may drop what S tokens and a step keep."""
    extra = {}
    if "moe" in arch or "grok" in arch:
        m = _get(arch, True).moe
        extra["moe"] = dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k)
    cfg = _get(arch, False, dtype="float32", **extra)
    pcfg = _get(arch, True, dtype="float32", **extra)
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(3))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    B, S = 2, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1)) \
        .astype(np.int32)
    pos = np.full((B, 1), S, np.int32)
    _, full = plm.make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks)},
        PT.init_cache(pcfg, B, S + 1, "cpu"))
    caches, _ = plm.make_prefill_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks[:, :S])},
        PT.init_cache(pcfg, B, S + 1, "cpu"))
    _, step = plm.make_decode_step(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks[:, S:]),
                  "pos": torch.from_numpy(pos)}, caches)
    rc, _ = lm.make_prefill_step(cfg)(params,
                                      {"tokens": jnp.asarray(toks[:, :S])},
                                      T.init_cache(cfg, B, S + 1))
    _, want = lm.make_decode_step(cfg)(
        params, {"tokens": jnp.asarray(toks[:, S:]),
                 "pos": jnp.asarray(pos)}, rc)
    _close(step, want, LOGIT_TOL)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-2,
                               rtol=3e-2)


CLI_ARCHS = ["qwen2-moe-a2.7b", "qwen2-vl-7b", "musicgen-large",
             "grok-1-314b"]


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_cli_serve_matches_reference(monkeypatch, arch):
    """``serve.main`` of both packages with the reference's float32
    weights swapped into both: paged over xdma, the same tokens and
    install counts (every install fused); unpaged, the same tokens."""
    cfg, pcfg, params, pparams = _pair(arch, seed=0)
    monkeypatch.setattr(ref_serve, "reduce_for_smoke", lambda c: cfg)
    monkeypatch.setattr(ref_serve.T, "tree_init",
                        lambda defs, c, key: params)
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    flags = ["--arch", arch, "--smoke", "--requests", "5", "--slots", "2",
             "--max-new", "5"]
    want = ref_serve.main(flags + ["--kv-paging"])
    got = port_serve.main(flags + ["--kv-paging", "--device", "cpu"])
    assert got["outputs"] == want["outputs"]
    assert got["install"] == want["install"]
    assert got["install"]["fused"] == 5 and got["install"]["fallback"] == 0
    plain = port_serve.main(flags + ["--device", "cpu"])
    assert plain["outputs"] == want["outputs"]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_int8_kv_engine_matches_reference(paged):
    """``ServeEngine`` on a config with kv_dtype="int8" (there is no CLI
    flag, as in the reference): the reference engine's tokens, and with
    paging every slot's int8/float32 page installs through the fused
    kernel, nothing on the per-leaf fallback."""
    cfg, pcfg, params, pparams = _pair(INT8, seed=1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(5, 20, size=5)]
    kw = {"access_path": "xdma"} if paged else {}

    def run(engine, request_cls):
        for i, p in enumerate(prompts):
            engine.submit(request_cls(rid=i, prompt=p, max_new=6))
        assert engine.run_until_drained() == 0
        if engine.pager is not None:
            engine.pager.close()
        return {r.rid: list(r.out_tokens) for r in engine.done}

    want = run(RefEngine(cfg, params, batch_slots=2, max_len=32, **kw),
               RefRequest)
    eng = ServeEngine(pcfg, pparams, batch_slots=2, max_len=32,
                      device="cpu", **kw)
    assert run(eng, Request) == want
    if paged:
        assert (eng.install_fused, eng.install_fallback) == (5, 0)
        assert not eng._layout.fallback_indices()
