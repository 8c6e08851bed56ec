"""The port's flash attention on the CPU (its plain version, the
reference model's chunked attention) against the reference's Pallas
kernel in interpret mode and its dense oracle, over the grid of
``tests/test_kernels.py`` (S capped at 256) at its bars: 2e-5 in float32,
2e-2 in bf16; plus ragged lengths against the oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 2e-2)}


def _qkv(B, S, H, KV, dh, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(scale * rng.standard_normal((B, S, n, dh))).astype(np.float32)
            for n in (H, KV, KV)]
    jx = [jnp.asarray(x, dtype) for x in arrs]
    return jx, [interop.to_torch(np.asarray(x)) for x in jx]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,dh,causal,window", [
    (2, 256, 4, 2, 64, True, None),     # GQA causal
    (1, 256, 8, 8, 64, True, None),     # MHA
    (2, 256, 4, 1, 128, True, 128),     # MQA sliding window
    (1, 256, 4, 4, 64, False, None),    # bidirectional
    (1, 128, 2, 2, 64, True, None),     # small
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_reference(B, S, H, KV, dh, causal, window,
                                           dtype):
    jdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, S, H, KV, dh, jdt, seed=S + H + dh)
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, ops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, block_q=128,
                                    block_k=128, interpret=True), tol)
    _close(got, ops.attention_ref(jq, jk, jv, causal=causal, window=window),
           tol)


def test_flash_attention_logit_cap():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 128, 2, 2, 64, jnp.float32, 5)
    jq, jk = 5.0 * jq, 5.0 * jk
    tq, tk = 5.0 * tq, 5.0 * tk
    got = FA.flash_attention(tq, tk, tv, logit_cap=30.0)
    _close(got, ops.flash_attention(jq, jk, jv, logit_cap=30.0, block_q=64,
                                    block_k=64, interpret=True), 3e-5)
    _close(got, ops.attention_ref(jq, jk, jv, logit_cap=30.0), 3e-5)


@pytest.mark.parametrize("S,causal,window", [
    (12, True, None), (37, True, 8), (100, False, None), (100, True, 64),
    (33, False, 16),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_ragged_lengths(S, causal, window, dtype):
    """S that no block divides (the reference kernel asserts one does)."""
    jdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, S, 4, 2, 16, jdt, seed=S)
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, ops.attention_ref(jq, jk, jv, causal=causal, window=window),
           tol)


@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_version_tiles_like_the_reference_model(chunk):
    """``chunk`` reaches the plain version: several tiles, as the model's
    ``attn_chunk`` gives, agree with the reference's chunked attention."""
    from repro.models import layers as L
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 64, 4, 1, 16, jnp.float32, 9)
    got = FA.flash_attention(tq, tk, tv, window=24, chunk=chunk)
    want = jax.jit(lambda q, k, v: L.attention_chunked(
        q, k, v, window=24, chunk_q=chunk, chunk_k=chunk))(jq, jk, jv)
    _close(got, want, 2e-5)


def test_bad_arguments_raise():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="KV must divide H"):
        FA.flash_attention(q, torch.zeros(1, 8, 3, 16),
                           torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="dtypes differ"):
        FA.flash_attention(q, torch.zeros(1, 8, 2, 16).double(),
                           torch.zeros(1, 8, 2, 16).double())
    with pytest.raises(ValueError, match=r"\(B,S,KV,dh\)"):
        FA.flash_attention(q, torch.zeros(1, 8, 2, 16),
                           torch.zeros(1, 8, 1, 16))
