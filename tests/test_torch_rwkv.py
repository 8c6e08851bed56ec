"""The ported RWKV-6 block against the reference: the wkv chunk (one and
several), time-mix and channel-mix in prefill and decode, the chunk rule,
the three-leaf state tree, and the port's paged serve against a greedy
loop of the reference's own prefill and decode steps.  Float32 on both
sides, 2e-5 per op, tokens equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import rwkv as R  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import rwkv as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCH = "rwkv6-1.6b"
TOL = 2e-5


def _cfgs():
    return (dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                                dtype="float32"),
            dataclasses.replace(port_reduce(port_config(ARCH)),
                                dtype="float32"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _mix_params(cfg, seed=5):
    """The reference's rwkv block params, its "small" leaves scaled up so
    every mixing term moves the output."""
    p = T.tree_init(R.rwkv_defs(cfg), cfg, jax.random.PRNGKey(seed))
    p = {k: (np.asarray(v) * (20.0 if k in ("mu_x", "mu_rkvwg", "mix_a",
                                             "mix_b", "wa", "wb", "u",
                                             "cmu_k", "cmu_r") else 1.0))
         .astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _wkv_inputs(rng, B, T_, H, hs):
    """r, k, v and S0 at std 0.5 (|y| up to ~5); at std 1, |y| reaches
    ~40 and float32's summation order alone moves it by ~1e-4."""
    r, k, v = (0.5 * rng.standard_normal((B, T_, H, hs)).astype(np.float32)
               for _ in range(3))
    # decays from ~0.99 down to ~1e-3 a step: the [-60, 60] clamps bind
    w = np.exp(-np.exp(rng.uniform(-5.0, 2.0, (B, T_, H, hs)))) \
        .astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    S0 = 0.5 * rng.standard_normal((B, H, hs, hs)).astype(np.float32)
    return S0, r, k, v, w, u


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_wkv_chunk_matches_reference(n_chunks):
    rng = np.random.default_rng(n_chunks)
    S0, r, k, v, w, u = _wkv_inputs(rng, 2, 32 * n_chunks, 4, 16)
    S_ref, S_port = jnp.asarray(S0), torch.from_numpy(S0)
    for i in range(n_chunks):
        sl = slice(32 * i, 32 * (i + 1))
        y_ref, S_ref = R._wkv_chunk(S_ref, *(jnp.asarray(t[:, sl])
                                             for t in (r, k, v, w)),
                                    jnp.asarray(u))
        y_port, S_port = PR._wkv_chunk(S_port, *(torch.from_numpy(t[:, sl])
                                                 for t in (r, k, v, w)),
                                       torch.from_numpy(u))
        _close(y_port, y_ref)
        _close(S_port, S_ref)


@pytest.mark.parametrize("T_,chunk", [(24, 128), (64, 16)],
                         ids=["one-chunk", "four-chunks"])
def test_time_and_channel_mix_prefill_then_decode(T_, chunk):
    cfg, pcfg = _cfgs()
    jp, tp = _mix_params(cfg)
    rng = np.random.default_rng(T_)
    B, D = 2, cfg.d_model
    x = rng.standard_normal((B, T_, D)).astype(np.float32)
    st = {"S": 0.1 * rng.standard_normal((B, D // 16, 16, 16)),
          "tm_x": rng.standard_normal((B, D)), "cm_x":
          rng.standard_normal((B, D))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    o_ref, s_ref = R.rwkv_time_mix(cfg, jp, jnp.asarray(x), mode="prefill",
                                   state=jst, chunk=chunk)
    o_port, s_port = PR.rwkv_time_mix(pcfg, tp, torch.from_numpy(x),
                                      mode="prefill", state=tst, chunk=chunk)
    _close(o_port, o_ref)
    assert set(s_port) == set(s_ref) == {"S", "tm_x"}
    for key in s_ref:
        _close(s_port[key], s_ref[key])
    c_ref, cx_ref = R.rwkv_channel_mix(cfg, jp, jnp.asarray(x),
                                       mode="prefill", state=jst)
    c_port, cx_port = PR.rwkv_channel_mix(pcfg, tp, torch.from_numpy(x),
                                          mode="prefill", state=tst)
    _close(c_port, c_ref)
    _close(cx_port, cx_ref)
    # one decode step from the prefill's state
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    s_ref = dict(s_ref, cm_x=cx_ref)
    s_port = dict(s_port, cm_x=cx_port)
    o_ref, n_ref = R.rwkv_time_mix(cfg, jp, jnp.asarray(x1), mode="decode",
                                   state=s_ref)
    o_port, n_port = PR.rwkv_time_mix(pcfg, tp, torch.from_numpy(x1),
                                      mode="decode", state=s_port)
    _close(o_port, o_ref)
    for key in n_ref:
        _close(n_port[key], n_ref[key])
    c_ref, _ = R.rwkv_channel_mix(cfg, jp, jnp.asarray(x1), mode="decode",
                                  state=s_ref)
    c_port, _ = PR.rwkv_channel_mix(pcfg, tp, torch.from_numpy(x1),
                                    mode="decode", state=s_port)
    _close(c_port, c_ref)


def test_prefill_length_off_the_chunk_is_refused():
    """``T % min(chunk, T) != 0``: the reference asserts, the port raises
    ``ValueError``."""
    cfg, pcfg = _cfgs()
    jp, tp = _mix_params(cfg)
    x = np.zeros((1, 48, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        R.rwkv_time_mix(cfg, jp, jnp.asarray(x), mode="prefill", state=None,
                        chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk 32"):
        PR.rwkv_time_mix(pcfg, tp, torch.from_numpy(x), mode="prefill",
                         state=None, chunk=32)


def _paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_paths(tree[k], prefix + f"['{k}']")]
    return [(prefix, tuple(tree.shape), interop.dtype_name(tree))]


@pytest.mark.parametrize("smoke,batch,max_len", [(True, 1, 64),
                                                 (False, 4, 384)])
def test_state_tree_is_the_reference_prefill_output(smoke, batch, max_len):
    """C.3: the port's ``init_cache`` is the tree the reference's prefill
    returns (three leaves a layer: ``cm_x``, ``mix.S``, ``mix.tm_x``),
    not the reference's four-leaf ``init_cache``."""
    cfg, pcfg = get_config(ARCH), port_config(ARCH)
    if smoke:
        cfg, pcfg = _cfgs()
    prefill = lm.make_prefill_step(cfg)
    out = jax.eval_shape(lambda: prefill(
        T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0)),
        {"tokens": jnp.zeros((batch, 16), jnp.int32)},
        T.init_cache(cfg, batch, max_len))[0])
    port = _port_paths(PT.init_cache(pcfg, batch, max_len, "meta"))
    assert port == _paths(out)
    assert [p for p, _, _ in port] == [
        "['groups']['b0']['cm_x']", "['groups']['b0']['mix']['S']",
        "['groups']['b0']['mix']['tm_x']"]
    ref_init = _paths(jax.eval_shape(lambda: T.init_cache(cfg, batch,
                                                          max_len)))
    assert len(ref_init) == 4 and "['groups']['b0']['mix']['cm_x']" in [
        p for p, _, _ in ref_init]


def _reference_greedy(cfg, params, prompt, max_new, max_len):
    """The reference's own prefill and decode steps, one request."""
    prefill = jax.jit(lm.make_prefill_step(cfg))
    decode = jax.jit(lm.make_decode_step(cfg))
    caches, logits = prefill(params, {"tokens": jnp.asarray(prompt)[None]},
                             T.init_cache(cfg, 1, max_len))
    toks = [int(jnp.argmax(logits[0]))]
    for i in range(max_new - 1):
        caches, logits = decode(params, {
            "tokens": jnp.asarray([[toks[-1]]], jnp.int32),
            "pos": jnp.full((1, 1), len(prompt) + i, jnp.int32)}, caches)
        toks.append(int(jnp.argmax(logits[0])))
    return toks


@pytest.mark.parametrize("extra", [["--kv-paging"], ["--kv-paging",
                                                     "--no-overlap"], []],
                         ids=["paged", "paged-no-overlap", "unpaged"])
def test_serve_matches_reference_step_loop(monkeypatch, extra):
    """The port's CLI serve (4 requests on 2 slots, the reference's
    float32 weights) gives, per request, the tokens of a greedy loop of
    the reference's prefill and decode steps; the reference's own serve
    cannot run RWKV (C.3)."""
    cfg, pcfg = _cfgs()
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(2))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    n, max_new, P, max_len = 4, 5, 16, 32
    got = port_serve.main(["--arch", ARCH, "--smoke", "--requests", str(n),
                           "--slots", "2", "--max-new", str(max_new),
                           "--prompt-len", str(P), "--max-len", str(max_len),
                           "--device", "cpu"] + extra)
    prompts, _ = port_serve.draw_prompts(0, n, P, cfg.vocab)
    want = {r: _reference_greedy(cfg, params, prompts[r], max_new, max_len)
            for r in range(n)}
    assert got["outputs"] == want
    if extra:
        assert got["install"]["fused"] == n and \
            got["install"]["fallback"] == 0
