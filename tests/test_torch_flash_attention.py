"""The port's flash attention on the CPU (its plain version, the
reference model's chunked attention) against the reference's Pallas
kernel in interpret mode and its dense oracle, over the grid of
``tests/test_kernels.py`` (S capped at 256) at its bars: 2e-5 in float32,
2e-2 in bf16; plus ragged lengths against the oracle; and the bf16
kernel's host plan (launch structs against the CUDA source, q-tile
order, live k ranges against the dense mask, tensor maps)."""
import ctypes
import pathlib
import re

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


# ---------------------------------------------------------------------------
# the bf16 kernel's host plan: structs, q-tile order, live k ranges, TMA
# ---------------------------------------------------------------------------

CU = (pathlib.Path(FA.__file__).resolve().parent.parent / "csrc" /
      "flash_attention.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def _cu_fields(struct):
    body = re.search(rf"struct {struct} {{(.*?)\n}};", CU, re.S).group(1)
    return [(m.group(1), m.group(2)) for m in
            re.finditer(r"^\s*([A-Za-z_][\w ]*?)\s+"
                        r"(\w+(?:\[\w+\])?(?:, \w+(?:\[\w+\])?)*);",
                        body, re.M)]


def test_plan_structs_match_the_source():
    assert (_cu_const("kFaBQ"), _cu_const("kFaBK"),
            _cu_const("kFaMaxTiles")) == (FA.Q_ROWS, FA.K_ROWS,
                                          FA.MAX_PLAN_TILES)
    assert _cu_fields("FaTile") == [("int", "qt"), ("int", "lo, hi"),
                                    ("int", "c_lo[2], c_hi[2]")]
    assert [n for n, _ in FA.FaTile._fields_] == ["qt", "lo", "hi", "c_lo",
                                                 "c_hi"]
    assert _cu_fields("FaPlan") == [("int", "n"),
                                    ("FaTile", "tile[kFaMaxTiles]")]
    assert _cu_fields("TmaSpec") == [
        ("unsigned long long", "base"), ("unsigned long long", "dims[4]"),
        ("unsigned long long", "strides[3]"), ("unsigned int", "box[4]"),
        ("unsigned int", "swizzle")]
    # the C layouts: 7 ints; n then the tiles; 8 + 32 + 24 + 16 + 4 bytes,
    # padded to 8
    assert ctypes.sizeof(FA.FaTile) == 28
    assert ctypes.sizeof(FA.FaPlan) == 4 + 28 * FA.MAX_PLAN_TILES
    assert FA.FaPlan.tile.offset == 4
    assert ctypes.sizeof(FA.TmaSpec) == 88
    assert [getattr(FA.TmaSpec, f).offset for f in
            ("base", "dims", "strides", "box", "swizzle")] == \
        [0, 8, 40, 64, 80]
    # three 128-byte tensor maps, the params and the plan fit 4,096 bytes
    assert 3 * 128 + 64 + ctypes.sizeof(FA.FaPlan) <= 4096


MASKS = [(S, causal, window) for S in (12, 65, 2100)
         for causal in (True, False) for window in (None, 100, 2048)]


def _dense_mask(S, causal, window):
    q = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    m = np.ones((S, S), bool)
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    return m


def _needed(mask, r0, rows):
    """k tiles that hold a live (q, k) pair for q rows [r0, r0 + rows)."""
    cols = mask[r0:r0 + rows].any(axis=0)
    return {c // FA.K_ROWS for c in np.flatnonzero(cols)}


@pytest.mark.parametrize("S,causal,window", MASKS)
def test_q_tiles_are_visited_once_heaviest_first(S, causal, window):
    plans = FA.launch_plans(S, causal, window)
    tiles = [t for pl in plans for t in pl.tile[:pl.n]]
    assert sorted(t.qt for t in tiles) == list(range(-(-S // FA.Q_ROWS)))
    weights = [t.hi - t.lo for t in tiles]
    assert weights == sorted(weights, reverse=True)


@pytest.mark.parametrize("S,causal,window", MASKS)
def test_live_k_tiles_equal_the_dense_mask(S, causal, window):
    """Each plan tile's [lo, hi), and each consumer's, is exactly the set
    of k tiles that hold a live pair for its rows: no live tile dropped,
    no dead one visited."""
    mask = _dense_mask(S, causal, window)
    for pl in FA.launch_plans(S, causal, window):
        for t in pl.tile[:pl.n]:
            r0 = t.qt * FA.Q_ROWS
            assert set(range(t.lo, t.hi)) == _needed(mask, r0, FA.Q_ROWS)
            for c in range(2):
                assert set(range(t.c_lo[c], t.c_hi[c])) == \
                    _needed(mask, r0 + 64 * c, 64)
                assert t.lo <= t.c_lo[c] and t.c_hi[c] <= t.hi or \
                    t.c_lo[c] == t.c_hi[c]


def test_long_sequences_take_several_launches():
    S = FA.MAX_PLAN_TILES * FA.Q_ROWS + 5
    plans = FA.launch_plans(S, True, None)
    assert [pl.n for pl in plans] == [FA.MAX_PLAN_TILES, 1]
    assert sorted(t.qt for pl in plans for t in pl.tile[:pl.n]) == \
        list(range(FA.MAX_PLAN_TILES + 1))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("dh", FA.HEAD_DIMS)
def test_tensor_map_spec_addresses_every_element(layout, dh):
    """The tensor map's dims and byte strides reach each element of q
    where its own strides do, for the reference's (B, S, H, dh) layout
    and a (B, H, S, dh) tensor viewed through a transpose."""
    B, S, H = 2, 70, 3
    x = torch.zeros((B, S, H, dh), dtype=torch.bfloat16)
    if layout == "bhsd":
        x = torch.zeros((B, H, S, dh), dtype=torch.bfloat16).transpose(1, 2)
    sp = FA.tensor_map_spec(x, FA.Q_ROWS)
    assert tuple(sp.dims) == (dh, H, S, B)
    assert sp.swizzle == FA.swizzle_bytes(dh) and sp.swizzle <= 128
    assert tuple(sp.box) == (sp.swizzle // 2, 1, FA.Q_ROWS, 1)
    assert dh % sp.box[0] == 0 and all(st % 16 == 0 for st in sp.strides)
    sh, ss, sb = sp.strides
    b, s, h, d = np.meshgrid(*(np.arange(n) for n in (B, S, H, dh)),
                             indexing="ij")
    got = sp.base + 2 * d + sh * h + ss * s + sb * b
    st = x.stride()
    want = x.data_ptr() + 2 * (st[0] * b + st[1] * s + st[2] * h + d)
    np.testing.assert_array_equal(got, want)

