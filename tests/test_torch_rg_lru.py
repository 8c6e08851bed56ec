"""The port's RG-LRU scan against the reference's Pallas kernel (interpret
mode) and its associative-scan oracle, in float32 at 1e-5."""
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
