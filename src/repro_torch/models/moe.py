"""Mixture-of-Experts FFN with two dispatch modes.

Twin of ``repro/models/moe.py``, with its sharding constraints (``ctx``,
a ``repro_torch.sharding.ShardCtx``) where the reference pins them: the
grouped mode's dispatch buffers and output on ("batch", ...); the global
mode takes ``ctx`` and pins nothing, as in the reference.

* ``global`` (the default): the flat top-k assignments of all N tokens
  are sorted by expert id (a stable sort) and written into an (E, C, D)
  buffer, each expert keeping its first ``C = _round8(int(N*K*cf/E))``
  assignments; the rest go to a dump row at ``E*C`` and are dropped.
* ``grouped``: the same per batch row (GShard groups), with both
  dispatch and combine written as gathers.

The expert products ``ecd,edf->ecf`` are plain batched matmuls, as the
reference runs them as XLA; there is no TPU kernel for MoE.

The global combine is a gather, then a sum over each token's K
contributions taken in ascending expert order, the order in which the
reference's scatter-add (``.at[tok].add``) visits them.  It is not
``index_add_``, whose atomic adds on the card would make a bf16 sum,
and so the tokens, vary from run to run.

Batching cannot change a request's tokens in decode: a decode step
routes one token per batch row, so each expert takes at most B tokens
(a token's K experts are distinct), and ``C >= 8 >= B`` for the
engine's B <= 8 slots, so no assignment is dropped and every row's
output depends on that row alone.  A prefill routes one request's
tokens, whatever else is in the batch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, act_fn
from repro_torch.sharding import constrain, on_whole_values


def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    D = cfg.d_model
    defs = {
        "router": ParamDef((D, m.n_experts), ("d_model", "experts")),
        "we1": ParamDef((m.n_experts, D, m.d_expert),
                        ("experts", "d_model", "d_ff"), init="normal1"),
        "we3": ParamDef((m.n_experts, D, m.d_expert),
                        ("experts", "d_model", "d_ff"), init="normal1"),
        "we2": ParamDef((m.n_experts, m.d_expert, D),
                        ("experts", "d_ff", "d_model"), init="normal1"),
    }
    if m.d_shared:
        defs.update({
            "ws1": ParamDef((D, m.d_shared), ("d_model", "d_ff")),
            "ws3": ParamDef((D, m.d_shared), ("d_model", "d_ff")),
            "ws2": ParamDef((m.d_shared, D), ("d_ff", "d_model")),
            "wsg": ParamDef((D, 1), ("d_model", None), init="zeros"),
        })
    return defs


def _round8(c: int) -> int:
    return max(8, -(-c // 8) * 8)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    return _round8(int(n_tokens * m.top_k * m.capacity_factor / m.n_experts))


def _shared_expert(cfg, p, xf):
    g = xf @ p["ws1"]
    u = xf @ p["ws3"]
    sh = (act_fn(cfg.act)(g) * u) @ p["ws2"]
    gate = torch.sigmoid((xf @ p["wsg"]).float())
    return sh * gate.to(xf.dtype)


def _aux_loss(cfg, probs, counts, n_tokens):
    """Switch-style balance loss from the router's probabilities and the
    per-expert assignment counts the dispatch took."""
    m = cfg.moe
    pe = torch.mean(probs.float(), dim=tuple(range(probs.ndim - 1)))
    frac = counts.float() / (n_tokens * m.top_k)
    return m.n_experts * torch.sum(pe * frac) * m.router_aux_coef


def _counts(e: torch.Tensor, n: int) -> torch.Tensor:
    """Assignments per expert.  Not ``torch.bincount``, which reads the
    largest id back to the host on the card (a sync every layer)."""
    return torch.zeros(n, dtype=e.dtype, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))


def _experts(cfg, p, eb):
    """The gated expert FFNs over (..., E, C, D) dispatch buffers."""
    g = torch.matmul(eb, p["we1"])
    u = torch.matmul(eb, p["we3"])
    return torch.matmul(act_fn(cfg.act)(g) * u, p["we2"])


def moe_apply_global(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx=None):
    """Global-sort dispatch (see the module note).  Returns (out, aux)."""
    m = cfg.moe
    B, S, D = x.shape
    N, K, E = B * S, m.top_k, m.n_experts
    xf = x.reshape(N, D)

    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)            # (N, K)

    C = _capacity(cfg, N)
    NK = N * K
    flat_e = top_e.reshape(NK)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(K)

    order = torch.argsort(flat_e, stable=True)             # global sort
    e_sorted = flat_e[order]
    counts = _counts(flat_e, E)
    aux = _aux_loss(cfg, probs, counts, N)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(NK, device=x.device) - starts[e_sorted]
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank, E * C)

    # row E*C is the dump row: what lands there is dropped
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = xf[flat_tok[order]]
    eo = _experts(cfg, p, buf[:-1].reshape(E, C, D)).reshape(E * C, D)

    contrib = eo[torch.clamp(slot, max=E * C - 1)]
    contrib = contrib * top_p.reshape(NK)[order][:, None].to(x.dtype)
    contrib = torch.where(keep[:, None], contrib, 0)
    # grouped by token, each token's K in ascending expert id: a stable
    # sort of the expert-sorted assignments by token
    by_tok = torch.argsort(flat_tok[order], stable=True)
    per_tok = contrib[by_tok].reshape(N, K, D)
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + per_tok[:, j]

    if m.d_shared:
        out = out + _shared_expert(cfg, p, xf)
    return out.reshape(B, S, D), aux


def moe_apply_grouped(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      ctx=None):
    """Row-local dispatch: routing, sort, rank and capacity per batch
    row, dispatch and combine as gathers.  Returns (out, aux)."""
    m = cfg.moe
    B, S, D = x.shape
    K, E = m.top_k, m.n_experts
    NK = S * K
    dev = x.device

    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)            # (B, S, K)

    C = _capacity(cfg, S)
    EC = E * C
    flat_e = top_e.reshape(B, NK)
    flat_w = top_p.reshape(B, NK).to(x.dtype)
    flat_tok = torch.arange(S, device=dev).repeat_interleave(K)[None] \
        .expand(B, NK)

    order = torch.argsort(flat_e, dim=1, stable=True)     # per-row sort
    e_sorted = torch.gather(flat_e, 1, order)
    tok_sorted = torch.gather(flat_tok, 1, order)
    # searchsorted has no DTensor strategy: on the whole (B, NK) ids
    starts = on_whole_values(lambda e: torch.searchsorted(
        e, torch.arange(E, device=dev)[None].expand(B, E).contiguous()),
        e_sorted)
    seg_end = torch.cat([starts[:, 1:],
                         torch.full((B, 1), NK, dtype=starts.dtype,
                                    device=dev)], dim=1)
    aux = _aux_loss(cfg, probs, torch.sum(seg_end - starts, dim=0), B * S)

    # dispatch (gather): slot (e, c) <- sorted position starts[e] + c
    pos = starts[:, :, None] + torch.arange(C, device=dev)[None, None]
    valid = pos < seg_end[:, :, None]
    posc = torch.clamp(pos, max=NK - 1).reshape(B, EC)
    gtok = torch.gather(tok_sorted, 1, posc)                # (B, EC)
    eb = torch.gather(x, 1, gtok[..., None].expand(B, EC, D))
    eb = eb.reshape(B, E, C, D) * valid[..., None].to(x.dtype)
    eb = constrain(eb, ("batch", None, None, None), ctx)
    eo = constrain(_experts(cfg, p, eb), ("batch", None, None, None), ctx)

    # combine (gather): invert the permutation, slot arithmetic
    inv = torch.argsort(order, dim=1)                      # (B, NK)
    rank = inv - torch.gather(starts, 1, flat_e)
    slot = torch.where(rank < C, flat_e * C + rank, EC)
    eo_flat = torch.cat([eo.reshape(B, EC, D),
                         torch.zeros((B, 1, D), dtype=x.dtype, device=dev)],
                        dim=1)
    contrib = torch.gather(eo_flat, 1,
                           torch.clamp(slot, max=EC)[..., None]
                           .expand(B, NK, D))
    contrib = contrib * flat_w[..., None]
    contrib = torch.where((rank < C)[..., None], contrib, 0)
    out = constrain(contrib.reshape(B, S, K, D).sum(dim=2),
                    ("batch", None, None), ctx)

    if m.d_shared:
        out = out + _shared_expert(cfg, p,
                                   x.reshape(B * S, D)).reshape(B, S, D)
    return out, aux


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, ctx=None):
    if cfg.moe_dispatch == "grouped":
        return moe_apply_grouped(cfg, p, x, ctx)
    # the global sort and scatter cross the batch shards and have no
    # DTensor strategy: each rank dispatches the whole batch
    return on_whole_values(lambda p, x: moe_apply_global(cfg, p, x, ctx),
                           p, x)
