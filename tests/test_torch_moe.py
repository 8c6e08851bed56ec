"""The ported MoE FFN against the reference: global and grouped
dispatch, outputs and the balance loss, at the default capacity and at
one tight enough to drop assignments; float32 on both sides, 2e-5.  The
router logits are continuous draws, so no top-k tie decides an expert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import moe as M  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

TOL = 2e-5


def _cfgs(arch, dispatch, capacity_factor=None):
    out = []
    for get, red in ((get_config, reduce_for_smoke),
                     (port_config, port_reduce)):
        cfg = red(get(arch))
        moe = cfg.moe if capacity_factor is None else dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, dtype="float32", moe=moe,
                                       moe_dispatch=dispatch))
    return out


def _params(cfg, seed=4):
    p = T.tree_init(M.moe_defs(cfg), cfg, jax.random.PRNGKey(seed))
    p = {k: np.asarray(v) for k, v in p.items()}
    if "wsg" in p:      # its init is zeros: a live shared-expert gate
        p["wsg"] = np.random.default_rng(seed).standard_normal(
            p["wsg"].shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _dropped(cfg, x, p):
    """Assignments past capacity, by the reference's routing."""
    m = cfg.moe
    B, S, D = x.shape
    logits = np.asarray(x).reshape(-1, D) @ np.asarray(p["router"])
    top = np.argsort(-logits, axis=-1)[:, :m.top_k]
    if cfg.moe_dispatch == "grouped":
        C = M._round8(int(S * m.top_k * m.capacity_factor / m.n_experts))
        counts = [np.bincount(t.reshape(-1), minlength=m.n_experts)
                  for t in top.reshape(B, S * m.top_k)]
    else:
        C = M._round8(int(B * S * m.top_k * m.capacity_factor /
                          m.n_experts))
        counts = [np.bincount(top.reshape(-1), minlength=m.n_experts)]
    return int(sum(np.maximum(c - C, 0).sum() for c in counts))


@pytest.mark.parametrize("capacity", [None, 0.25], ids=["default", "tight"])
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_apply_matches_reference(arch, dispatch, capacity):
    cfg, pcfg = _cfgs(arch, dispatch, capacity)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(len(arch) + len(dispatch))
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out_ref, aux_ref = M.moe_apply(cfg, jp, jnp.asarray(x))
    out_port, aux_port = PM.moe_apply(pcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out_port.numpy(), np.asarray(out_ref),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux_port), float(aux_ref),
                               atol=TOL, rtol=TOL)
    assert aux_port.dtype == torch.float32 and aux_port.ndim == 0
    drops = _dropped(cfg, x, jp)
    assert (drops > 0) == (capacity is not None), drops


def test_capacity_rule_and_decode_never_drops():
    """``C = _round8(int(N*K*cf/E))`` as the reference; a decode step of
    B <= 8 tokens fits every expert (each takes at most B)."""
    for n in (1, 4, 8, 12, 256, 1000):
        for arch in ("qwen2-moe-a2.7b", "grok-1-314b"):
            cfg = port_config(arch)
            m = cfg.moe
            assert PM._capacity(cfg, n) == M._round8(
                int(n * m.top_k * m.capacity_factor / m.n_experts))
            if n <= 8:
                assert PM._capacity(cfg, n) >= n


# ---------------------------------------------------------------------------
# the global mode on token shards and expert shards (the DTensor route's
# local function, ``_route_shard``), simulated on one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_mm_is_the_per_segment_products(dtype):
    """``segment_mm`` against a matmul a segment, with an empty segment
    and rows past the last end (zeros), and both gradients against
    autograd through the per-segment matmuls; the cost pass's formula
    counts 2 M K N for the forward and for each backward product."""
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(1)
    a = torch.randn(11, 8, generator=g, dtype=dtype)
    b = torch.randn(3, 8, 4, generator=g, dtype=dtype)
    offs = torch.tensor([3, 3, 9])
    ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
    ra, rb = a.clone().requires_grad_(), b.clone().requires_grad_()
    with FlopCounterMode(display=False) as fc:
        got = PM.segment_mm(ga, gb, offs)
        dy = torch.randn(got.shape, generator=g, dtype=dtype)
        da, db = torch.autograd.grad(got, (ga, gb), dy)
    want = torch.cat([ra[:3] @ rb[0], ra[3:9] @ rb[2],
                      torch.zeros(2, 4, dtype=dtype)])
    wa, wb = torch.autograd.grad(want, (ra, rb), dy)
    tol = 1e-12 if dtype == torch.float64 else TOL
    for x, y in ((got, want), (da, wa), (db, wb)):
        assert x.dtype == dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, atol=tol, rtol=tol)
    assert fc.get_total_flops() == 3 * 2 * 11 * 8 * 4
    meta = PM.segment_mm(a.to("meta"), b.to("meta"), offs.to("meta"))
    assert meta.shape == (11, 4) and meta.device.type == "meta"


def _on_shards(pcfg, tp, x, nb, ns, split):
    """The routed output and balance loss of the global mode over ``nb``
    batch shards x ``ns`` position shards of ``x``, each on ``split``
    halves of the experts ("experts") or of d_expert ("d_ff"), summed as
    the route's partial sums are: ``_route_shard`` with the counts of
    every shard gathered as ``moe._on_token_shards`` gathers them."""
    B, S, D = x.shape
    E = pcfg.moe.n_experts
    Bl, Sl = B // nb, S // ns
    shards = [(i, j) for i in range(nb) for j in range(ns)]
    every = torch.zeros((B, ns, E), dtype=torch.int64)

    def piece(t, i, j):
        return t[i * Bl:(i + 1) * Bl, j * Sl:(j + 1) * Sl]

    def record(i, j):
        def prior(cnt):
            every[i * Bl:(i + 1) * Bl, j] = cnt
            return torch.zeros_like(cnt), cnt.sum(0)
        return prior

    w = {k: tp[k] for k in ("router", "we1", "we3", "we2")}
    for i, j in shards:
        PM._route_shard(pcfg, piece(x, i, j), *w.values(),
                        n_tokens=B * S, prior=record(i, j))
    flat = every.reshape(B * ns, E)
    before = torch.cumsum(flat, 0) - flat

    def prior(i, j):
        segs = (i * Bl + torch.arange(Bl)) * ns + j
        return lambda cnt: (before[segs], flat.sum(0))

    halves = []
    if split == "experts":
        h = E // 2
        halves = [(e0, {k: w[k][e0:e0 + h] for k in ("we1", "we3", "we2")})
                  for e0 in (0, h)]
    else:
        f = pcfg.moe.d_expert // 2
        halves = [(0, {"we1": w["we1"][..., f0:f0 + f],
                       "we3": w["we3"][..., f0:f0 + f],
                       "we2": w["we2"][:, f0:f0 + f]}) for f0 in (0, f)]
    out = torch.zeros_like(x)
    aux = torch.zeros((), dtype=torch.float32)
    for i, j in shards:
        for n, (e0, we) in enumerate(halves):
            o, a = PM._route_shard(pcfg, piece(x, i, j), w["router"],
                                   we["we1"], we["we3"], we["we2"],
                                   n_tokens=B * S, prior=prior(i, j), e0=e0)
            piece(out, i, j).add_(o)
            if n == 0:
                aux = aux + a
    return out, aux


@pytest.mark.parametrize("split", ["experts", "d_ff"])
@pytest.mark.parametrize("shards", [(2, 1), (1, 2), (2, 2)],
                         ids=["batch", "seq", "batch-seq"])
@pytest.mark.parametrize("capacity", [None, 0.25], ids=["default", "tight"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_token_shards_keep_the_references_assignments(arch, capacity,
                                                      shards, split):
    """The global mode as the DTensor route runs it, on token shards of
    batch rows, of positions or both, and on halves of the experts or
    of d_expert, summed over the shards, plus the shared expert: the
    reference's ``moe_apply_global`` at 2e-5 (float32), its balance
    loss too, at the default capacity and at one that drops.  A shard
    keeps an assignment when its rank in its expert over all tokens
    before it, in the global (B, S) order, is below the global C."""
    cfg, pcfg = _cfgs(arch, "global", capacity)
    jp, tp = _params(cfg)
    rng = np.random.default_rng(len(arch) + 7)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out_ref, aux_ref = M.moe_apply_global(cfg, jp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    out, aux = _on_shards(pcfg, tp, xt, *shards, split)
    if pcfg.moe.d_shared:
        out = out + PM._shared_expert(pcfg, tp, xt.reshape(
            -1, cfg.d_model)).reshape(out.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=TOL,
                               rtol=TOL)
    drops = _dropped(cfg, x, jp)
    assert (drops > 0) == (capacity is not None), drops
