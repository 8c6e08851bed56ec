"""The port's RG-LRU scan against the reference's Pallas kernel (interpret
mode) and its associative-scan oracle, in float32 at 1e-5; the kernel's
launch plan and tensor map against its CUDA source."""
import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import rg_lru as R  # noqa: E402

TOL = 1e-5


def _inputs(B, T, W, seed, h0=True):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, W)).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h = rng.standard_normal((B, W)).astype(np.float32) if h0 else None
    return a, b, h


def _port(a, b, h0):
    return R.rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         None if h0 is None else torch.from_numpy(h0))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("B,T,W,bt,bw", [
    (2, 64, 128, 16, 128), (1, 128, 256, 64, 128), (3, 32, 128, 32, 128),
    (1, 64, 512, 8, 256),
])
def test_rg_lru_scan_matches_reference(B, T, W, bt, bw):
    a, b, h0 = _inputs(B, T, W, seed=B * T + W)
    got = _port(a, b, h0)
    _close(got, ops.rg_lru_scan(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(h0), block_t=bt, block_w=bw,
                                interpret=True))
    _close(got, ops.rg_lru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0)))


@pytest.mark.parametrize("B,T,W,h0", [
    (1, 37, 100, True), (2, 5, 33, False), (1, 1, 64, True),
    (1, 16, 128, False),
])
def test_rg_lru_scan_ragged_and_no_initial_state(B, T, W, h0):
    """T and W need not divide into blocks; h0=None means zeros.  The
    reference kernel takes these shapes as one block each."""
    a, b, h = _inputs(B, T, W, seed=T + W, h0=h0)
    got = _port(a, b, h)
    jh = None if h is None else jnp.asarray(h)
    _close(got, ops.rg_lru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh))
    _close(got, ops.rg_lru_scan(jnp.asarray(a), jnp.asarray(b), jh,
                                interpret=True))


def test_plain_version_is_the_recurrence():
    a, b, h0 = _inputs(2, 9, 7, seed=3)
    got = R.rg_lru_scan_torch(*map(torch.from_numpy, (a, b, h0))).numpy()
    h = h0.copy()
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_array_equal(got[:, t], h)


def test_bad_arguments_raise():
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="float32"):
        R.rg_lru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match=r"\(B, T, W\)"):
        R.rg_lru_scan(a, a[:, :2])
    with pytest.raises(ValueError, match="h0"):
        R.rg_lru_scan(a, a, torch.ones(1, 4))


# the kernel's host side: its launch plan and tensor map against the CUDA
# source

CU = (pathlib.Path(R.__file__).resolve().parent.parent / "csrc" /
      "rg_lru.cu").read_text()
N_SMS = 132
SHAPES = [(1, 2100, 2560), (4, 2048, 2560), (2, 1001, 776), (2, 1001, 770),
          (1, 333, 130), (1, 1, 64), (2, 5, 33), (64, 2048, 2560),
          (1, 100000, 16), (3, 64, 4096)]


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def _cu_fields(struct):
    body = re.search(rf"struct {struct} {{(.*?)\n}};", CU, re.S).group(1)
    return re.findall(r"^\s*(int|unsigned long long|unsigned int) (\w+)"
                      r"(?:\[(\d)\])?;", body, re.M)


def test_plan_structs_and_constants_match_the_source():
    ctype = {"int": ctypes.c_int, "unsigned long long": ctypes.c_ulonglong,
             "unsigned int": ctypes.c_uint}
    for py, struct in ((R.LruPlan, "LruPlan"), (R.LruMap, "LruMap")):
        want = [(name, ctype[t] * int(n) if n else ctype[t])
                for t, name, n in _cu_fields(struct)]
        assert py._fields_ == want
    assert R.STEPS == _cu_const("kSteps")
    assert R.MAX_SMEM == _cu_const("kMaxSmem")
    assert R.STEPS % _cu_const("kGroup") == 0
    assert "((16 * stages + 127) / 128) * 128" in CU
    assert all(R.header_bytes(s) == (16 * s + 127) // 128 * 128
               for s in range(1, 40))


@pytest.mark.parametrize("B,T,W", SHAPES)
def test_tensor_map_is_what_the_kernel_checks(B, T, W):
    """Evaluate the source's ``map_matches`` on the wrapper's map."""
    body = re.search(r"bool map_matches\(.*?\) \{\s*return (.*?);\n\}", CU,
                     re.S).group(1)
    expr = re.sub(r"static_cast<unsigned(?: long long)?>\((.*?)\)", r"(\1)",
                  body)
    expr = "(" + expr.replace("4ULL", "4").replace("&&", " and ") + ")"
    pl = R.plan(B, T, W, N_SMS)
    m = R.tensor_map(pl, B, T, W)
    assert eval(expr, {}, {"m": m, "pl": pl, "B": B, "T": T, "W": W})
    assert tuple(m.dims) == (W, T, B)
    assert tuple(m.strides) == (4 * W, 4 * T * W)
    assert tuple(m.box) == (pl.tile, R.STEPS, 1)
    bad = R.tensor_map(pl, B, T + 1, W)
    assert not eval(expr, {}, {"m": bad, "pl": pl, "B": B, "T": T, "W": W})


@pytest.mark.parametrize("B,T,W", SHAPES)
def test_plan_covers_every_channel_of_every_row_once(B, T, W):
    """CTA i takes batch row i // n_tiles and channels from
    (i % n_tiles) * tile, as the kernel reads blockIdx.x."""
    assert "const int bi = blockIdx.x / p.n_tiles;" in CU
    assert "const int c0 = (blockIdx.x - bi * p.n_tiles) * TILE;" in CU
    pl = R.plan(B, T, W, N_SMS)
    n_tiles = -(-W // pl.tile)
    seen = np.zeros((B, W), dtype=np.int64)
    for i in range(R.n_ctas(pl, B, W)):
        bi, c0 = i // n_tiles, (i % n_tiles) * pl.tile
        seen[bi, c0:min(c0 + pl.tile, W)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,T,W", SHAPES)
def test_plan_ring_fits_shared_memory(B, T, W):
    pl = R.plan(B, T, W, N_SMS)
    chunks = -(-T // R.STEPS)
    assert pl.tile in R.TILES and pl.steps == R.STEPS
    assert R.smem_bytes(pl) <= R.MAX_SMEM
    assert R.smem_bytes(pl) == R.header_bytes(pl.stages) + \
        2 * (pl.stages + 1) * R.STEPS * pl.tile * 4
    # at least two stages where the scan has two (the kernel refuses one)
    assert min(2, chunks) <= pl.stages <= chunks
    more = R.LruPlan(tile=pl.tile, steps=pl.steps, stages=pl.stages + 1,
                     tma=pl.tma)
    assert pl.stages == chunks or R.smem_bytes(more) > R.MAX_SMEM or \
        R.n_ctas(pl, B, W) * pl.stages * R.stage_bytes(pl) >= R.IN_FLIGHT


@pytest.mark.parametrize("B,T,W,want", [
    (1, 2100, 2560, (16, 64, 7, 1)),     # the hybrid prefill: 160 CTAs
    (4, 2048, 2560, (32, 64, 2, 1)),     # 320 CTAs
])
def test_plan_keeps_the_target_bytes_in_flight(B, T, W, want):
    pl = R.plan(B, T, W, N_SMS)
    assert (pl.tile, pl.steps, pl.stages, pl.tma) == want
    assert R.n_ctas(pl, B, W) * pl.stages * R.stage_bytes(pl) >= R.IN_FLIGHT
    assert R.n_ctas(pl, B, W) >= N_SMS


@pytest.mark.parametrize("W,aligned,tma", [
    (2560, True, 1), (776, True, 1), (770, True, 0), (130, True, 0),
    (33, True, 0), (2560, False, 0),
])
def test_route_is_tma_where_rows_are_16_byte_multiples(W, aligned, tma):
    assert R.plan(1, 100, W, N_SMS, aligned=aligned).tma == tma


def test_cpu_scan_does_not_count_launches():
    before = R.rg_lru_scan.launches
    R.rg_lru_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 8))
    assert R.rg_lru_scan.launches == before
