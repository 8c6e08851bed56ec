"""Dense-attention primitives of the port against the reference, in
float32 at the tolerance ``tests/test_kernels.py`` uses (2e-5)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402

TOL = 2e-5


def _cfgs():
    ref = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    port = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    return ref, port


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def _attn_params(rng, cfg):
    a = cfg.attention
    D, H, KV, dh = cfg.d_model, a.n_heads, a.n_kv_heads, a.d_head
    return {"wq": _rand(rng, D, H, dh, scale=D ** -0.5),
            "wk": _rand(rng, D, KV, dh, scale=D ** -0.5),
            "wv": _rand(rng, D, KV, dh, scale=D ** -0.5),
            "wo": _rand(rng, H, dh, D, scale=(H * dh) ** -0.5),
            "bq": _rand(rng, H, dh, scale=0.1),
            "bk": _rand(rng, KV, dh, scale=0.1),
            "bv": _rand(rng, KV, dh, scale=0.1)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, 2, 5, 64), _rand(rng, 64, scale=0.1)
    _close(PL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           L.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 100, (2, 7)).astype(np.int32)
    _close(PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           L.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("S,chunk", [(64, 16), (12, 8), (33, 32)])
def test_attention_chunked(S, chunk):
    """Even S tiles into chunks; odd S falls back to one full tile."""
    rng = np.random.default_rng(S)
    q, k, v = _rand(rng, 2, S, 4, 16), _rand(rng, 2, S, 2, 16), \
        _rand(rng, 2, S, 2, 16)
    _close(PL.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), chunk_q=chunk,
                                chunk_k=chunk),
           L.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), chunk_q=chunk, chunk_k=chunk))


def test_decode_attention():
    rng = np.random.default_rng(2)
    q, kc, vc = _rand(rng, 3, 1, 4, 16), _rand(rng, 3, 20, 2, 16), \
        _rand(rng, 3, 20, 2, 16)
    cur = np.array([5, 20, 1], np.int32)
    _close(PL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(cur)),
           L.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(cur)))


def test_attention_apply_prefill_then_decode():
    """Prefill writes the pre-sized cache; decode scatters one row per
    batch element at its own position (rows at different lengths)."""
    ref_cfg, port_cfg = _cfgs()
    a = ref_cfg.attention
    rng = np.random.default_rng(3)
    jp, tp = _both(_attn_params(rng, ref_cfg))
    B, S, Smax = 2, 6, 16
    x = _rand(rng, B, S, ref_cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    zeros = np.zeros((B, Smax, a.n_kv_heads, a.d_head), np.float32)
    jc = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros),
          "len": jnp.zeros((B,), jnp.int32)}
    tc = {"k": torch.from_numpy(zeros.copy()),
          "v": torch.from_numpy(zeros.copy()),
          "len": torch.zeros((B,), dtype=torch.int32)}
    jo, jc = L.attention_apply(ref_cfg, jp, jnp.asarray(x), mode="prefill",
                               pos=jnp.asarray(pos), cache=jc)
    to, tc = PL.attention_apply(port_cfg, tp, torch.from_numpy(x),
                                mode="prefill", pos=torch.from_numpy(pos),
                                cache=tc)
    _close(to, jo)
    for key in ("k", "v", "len"):
        _close(tc[key], jc[key])
    # rows at different lengths: the scatter lands per row
    lens = np.array([6, 3], np.int32)
    jc["len"], tc["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(3):
        xd = _rand(rng, B, 1, ref_cfg.d_model)
        pd = (lens + step)[:, None].astype(np.int32)
        jo, jc = L.attention_apply(ref_cfg, jp, jnp.asarray(xd),
                                   mode="decode", pos=jnp.asarray(pd),
                                   cache=jc)
        to, tc = PL.attention_apply(port_cfg, tp, torch.from_numpy(xd),
                                    mode="decode",
                                    pos=torch.from_numpy(pd), cache=tc)
        _close(to, jo)
        for key in ("k", "v", "len"):
            _close(tc[key], jc[key])


def test_mlp_apply():
    ref_cfg, port_cfg = _cfgs()
    rng = np.random.default_rng(4)
    D, F = ref_cfg.d_model, ref_cfg.d_ff
    p = {"w1": _rand(rng, D, F, scale=D ** -0.5),
         "w3": _rand(rng, D, F, scale=D ** -0.5),
         "w2": _rand(rng, F, D, scale=F ** -0.5)}
    jp, tp = _both(p)
    x = _rand(rng, 2, 5, D)
    _close(PL.mlp_apply(port_cfg, tp, torch.from_numpy(x)),
           L.mlp_apply(ref_cfg, jp, jnp.asarray(x)))


def test_unported_features_raise():
    """Every arch of ``ARCHS`` runs in the port, the int8 KV cache
    included; only a block kind that no model has is refused."""
    from repro_torch.configs import ARCHS
    for arch in ARCHS:
        cfg = port_config(arch)
        PL.check_supported(cfg)
        PL.check_supported(dataclasses.replace(cfg, kv_dtype="int8"))
    with pytest.raises(ValueError, match="unknown block kinds"):
        PL.check_supported(dataclasses.replace(
            port_config("qwen2-0.5b"), block_pattern=("attn", "mamba")))
