"""The port's kernels under autograd against ``jax.grad`` of the
reference's plain ops: ``FlashAttention`` (the forward, the PyTorch
backward ``flash_attention_bwd``) against the reference model's
``attention_chunked``, and ``RgLruScan`` (the reversed scan) against
``_scan_recurrence``.  On the CPU the wrappers'
forwards are their plain versions, and the backwards are the code that
runs on the card.  Float32 on both sides, 2e-5 per op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as L  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rg_lru as R  # noqa: E402

TOL = 2e-5

# (B, S, H, KV, dh, chunk, options): GQA groups 1 and 7, dh 64 and 256,
# a window shorter than S, the logit cap, bidirectional
FLASH_CASES = [
    (2, 48, 2, 2, 64, 16, {}),
    (1, 40, 14, 2, 64, 8, {}),
    (1, 48, 7, 1, 256, 16, {}),
    (2, 48, 4, 4, 64, 16, {"window": 10}),
    (1, 64, 14, 2, 64, 16, {"window": 20, "logit_cap": 5.0}),
    (2, 32, 4, 2, 256, 32, {"logit_cap": 3.0}),
    (1, 24, 4, 2, 64, 8, {"causal": False}),
    (1, 30, 4, 2, 16, 1024, {"window": 7, "scale": 0.3}),
]


def _flash_inputs(B, S, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, dh), f(B, S, KV, dh), f(B, S, KV, dh), f(B, S, H, dh)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])) +
                         "".join(f"-{k}{v}" for k, v in c[6].items()))
def test_flash_grads_match_jax_grad_of_reference(case):
    """dq, dk, dv of ``sum(o * w)`` through ``FlashAttention`` equal
    ``jax.grad`` through the reference's ``attention_chunked``."""
    B, S, H, KV, dh, chunk, opts = case
    q, k, v, w = _flash_inputs(B, S, H, KV, dh)

    def ref_loss(q, k, v):
        o = L.attention_chunked(q, k, v, chunk_q=chunk, chunk_k=chunk,
                                **opts)
        return jnp.sum(o * w)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(qt, kt, vt, chunk=chunk, **opts)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)),
                              (qt, kt, vt))
    for g, wg in zip(got, want):
        _close(g, wg)


@pytest.mark.parametrize("case", FLASH_CASES[:6],
                         ids=lambda c: "-".join(map(str, c[:6])))
def test_flash_autograd_output_matches_reference(case):
    """``FlashAttention``'s forward (the output under autograd, whose
    node the backward hangs on) equals the reference's
    ``attention_chunked`` at the same chunk."""
    B, S, H, KV, dh, chunk, opts = case
    q, k, v, _ = _flash_inputs(B, S, H, KV, dh, seed=1)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(qt, kt, vt, chunk=chunk, **opts)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert o.shape == (B, S, H, dh) and o.dtype == torch.float32
    _close(o, L.attention_chunked(q, k, v, chunk_q=chunk, chunk_k=chunk,
                                  **opts))


def test_flash_backward_reads_o_and_lse_not_the_forward(monkeypatch):
    """The backward reads only the saved q, k, v and ``do``: it rebuilds
    P itself, and with the plain forward made to raise after the
    forward, the gradients still come."""
    q, k, v, w = _flash_inputs(1, 16, 4, 2, 16, seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = FA.flash_attention(qt, kt, vt)

    def boom(*a, **kw):
        raise AssertionError("the backward ran the forward again")
    monkeypatch.setattr(FA, "attention_chunked", boom)
    g = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), (qt,))[0]
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_flash_without_grad_keeps_the_plain_route():
    """No input requiring grad, or grad mode off: the plain call, no
    autograd node, the same values as under autograd."""
    q, k, v, _ = _flash_inputs(1, 20, 4, 2, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    plain = FA.flash_attention(qt, kt, vt, window=5)
    assert plain.grad_fn is None
    with torch.no_grad():
        ng = FA.flash_attention(qt.requires_grad_(), kt, vt, window=5)
    assert ng.grad_fn is None
    ag = FA.flash_attention(qt, kt, vt, window=5)
    assert ag.grad_fn is not None
    assert torch.equal(ag.detach(), plain) and torch.equal(ng, plain)


def test_flash_bwd_in_q_chunks_equals_one_chunk():
    """``flash_attention_bwd``'s q-chunking changes no value."""
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(
        2, 37, 6, 2, 16, seed=4))
    one = FA.flash_attention_bwd(q, k, v, do, window=11,
                                 logit_cap=4.0, chunk=1024)
    many = FA.flash_attention_bwd(q, k, v, do, window=11,
                                  logit_cap=4.0, chunk=5)
    for a, b in zip(one, many):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# bf16 at large scores (ROADMAP C.4): q and k at std 60 put the scores at
# 10^3-10^4, where a bf16 ulp is 8-64, so the backward must rebuild them as
# the CPU forward rounded them; held to 2e-2 of each gradient's largest
# entry (bf16's own rounding of dS, dP and P in autograd's graph)
BF16_TOL = 2e-2
BF16_CASES = [
    (1, 64, 2, 1, 256, 16, {}),
    (1, 64, 4, 2, 128, 16, {"window": 24}),
    (1, 64, 4, 2, 128, 32, {"logit_cap": 30.0}),
]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])) +
                         "".join(f"-{k}{v}" for k, v in c[6].items()))
def test_bf16_flash_grads_at_large_scores_match_autograd(case):
    """bf16 on the CPU, q and k at std 60: dq, dk, dv through
    ``FlashAttention`` are finite and equal autograd through
    ``attention_chunked`` in bf16 within ``BF16_TOL`` of the largest
    entry."""
    B, S, H, KV, dh, chunk, opts = case
    rng = np.random.default_rng(5)
    f = lambda std, *s: torch.from_numpy(
        (std * rng.standard_normal(s)).astype(np.float32)).bfloat16()
    q, k = f(60.0, B, S, H, dh), f(60.0, B, S, KV, dh)
    v, do = f(1.0, B, S, KV, dh), f(1.0, B, S, H, dh)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins), ins, do)
    got = grads(lambda *t: FA.flash_attention(*t, chunk=chunk, **opts))
    want = grads(lambda *t: FA.attention_chunked(
        *t, chunk_q=chunk, chunk_k=chunk, **opts))
    for g, wg in zip(got, want):
        g, wg = g.float(), wg.float()
        assert bool(torch.isfinite(g).all())
        top = float(wg.abs().max())
        assert float((g - wg).abs().max()) <= BF16_TOL * top, (
            float((g - wg).abs().max()), top)


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])) +
                         "".join(f"-{k}{v}" for k, v in c[6].items()))
def test_bf16_kernel_route_grads_at_large_scores(case):
    """The card's route on the CPU: ``flash_attention_bwd`` with float32
    scores (its default, as the bf16 kernel's accumulators hold them)
    on the bf16 inputs: within ``BF16_TOL`` of autograd through the
    float32 plain version at std-60 q and k, nearly one-hot rows
    included."""
    B, S, H, KV, dh, chunk, opts = case
    rng = np.random.default_rng(6)
    f = lambda std, *s: torch.from_numpy(
        (std * rng.standard_normal(s)).astype(np.float32)).bfloat16()
    q, k = f(60.0, B, S, H, dh), f(60.0, B, S, KV, dh)
    v, do = f(1.0, B, S, KV, dh), f(1.0, B, S, H, dh)
    got = FA.flash_attention_bwd(q, k, v, do, **opts)
    ins = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(FA.attention_chunked(*ins, **opts), ins,
                               do.float())
    for g, wg in zip(got, want):
        assert bool(torch.isfinite(g).all())
        top = float(wg.abs().max())
        assert float((g.float() - wg).abs().max()) <= BF16_TOL * top


# ---------------------------------------------------------------------------
# rg_lru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,W,with_h0", [
    (2, 17, 6, True), (2, 17, 6, False), (3, 1, 5, True), (3, 1, 5, False),
    (1, 64, 33, True)])
def test_rg_lru_grads_match_jax_grad_of_scan_recurrence(B, T, W, with_h0):
    """da, db and dh0 of ``sum(h * w)`` through ``RgLruScan`` (the
    reversed scan) equal ``jax.grad`` through the reference's
    ``_scan_recurrence``, with and without h0, and at T = 1."""
    rng = np.random.default_rng(T + W)
    f32 = np.float32
    a = rng.uniform(0.5, 0.999, (B, T, W)).astype(f32)
    b = rng.standard_normal((B, T, W)).astype(f32)
    h0 = rng.standard_normal((B, W)).astype(f32)
    w = rng.standard_normal((B, T, W)).astype(f32)
    if with_h0:
        want = jax.grad(lambda a, b, h: jnp.sum(
            RG._scan_recurrence(a, b, h) * w), argnums=(0, 1, 2))(a, b, h0)
    else:
        want = jax.grad(lambda a, b: jnp.sum(
            RG._scan_recurrence(a, b, None) * w), argnums=(0, 1))(a, b)
    ins = [torch.from_numpy(x).requires_grad_()
           for x in ((a, b, h0) if with_h0 else (a, b))]
    h = R.rg_lru_scan(*ins)
    assert type(h.grad_fn).__name__ == "RgLruScanBackward"
    got = torch.autograd.grad(torch.sum(h * torch.from_numpy(w)), ins)
    for g, wg in zip(got, want):
        _close(g, wg)


def test_rg_lru_backward_calls_the_scan_once_reversed(monkeypatch):
    """The backward computes g with one call of the scan, on the flipped
    shifted gates and the flipped gradient (contiguous copies: the
    kernel's rule)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 0.9, (2, 9, 4)).astype(
        np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((2, 9, 4)).astype(
        np.float32)).requires_grad_()
    h = R.rg_lru_scan(a, b)
    calls = []
    real = R._scan

    def spy(x, y, h0=None):
        calls.append((x.is_contiguous(), y.is_contiguous(), h0))
        return real(x, y, h0)
    monkeypatch.setattr(R, "_scan", spy)
    torch.autograd.grad(h.sum(), (a, b))
    assert calls == [(True, True, None)]
