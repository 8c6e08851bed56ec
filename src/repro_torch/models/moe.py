"""Mixture-of-Experts FFN with two dispatch modes.

Twin of ``repro/models/moe.py``, with its sharding constraints (``ctx``,
a ``repro_torch.sharding.ShardCtx``) where the reference pins them: the
grouped mode's dispatch buffers and output on ("batch", ...); the global
mode takes ``ctx`` and pins nothing on one device, as in the reference
(under a mesh, the shared expert's gate: ``_shared_expert``).

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

Under a mesh (DTensor) the global mode runs on each rank's token shard
and expert shard, through ``local_map`` (``_on_token_shards``): the
reference gets the same split from GSPMD (its experts tensor-parallel
over "model" where 60 or 8 experts do not divide it).  A token shard is
a block of batch rows (and of positions, where the sequence is split
too), so the stable sort visits its assignments of an expert in token
order; an assignment is kept exactly when its rank among its shard's
assignments of that expert, plus that expert's assignments in every
token before its row, is below the global C.  Those counts are an
all-gather of (rows, E) integers, and the kept set is the one-device
step's at any capacity factor.  Each rank computes its local experts
(where "experts" splits) or every expert on its d_ff slice (where it
does not) on its own assignments sorted by expert, one segment an
expert (``segment_mm``), not on an (E, C, D) buffer: a buffer padded so
that no shard can drop wrongly would be 15x a rank's share for
qwen2-moe-a2.7b.  (Where the experts split, the cost pass counts the
product on all of a rank's assignments: which of them are its experts'
is data.)  The output is a partial sum over those mesh dims, which the
block's pin reduces.

Batching cannot change a request's tokens in decode: a decode step
routes one token per batch row, so each expert takes at most B tokens
(a token's K experts are distinct), and ``C >= 8 >= B`` for the
engine's B <= 8 slots, so no assignment is dropped and every row's
output depends on that row alone.  A prefill routes one request's
tokens, whatever else is in the batch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, act_fn
from repro_torch.sharding import (constrain, for_compute, is_dtensor,
                                  on_whole_values)


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


def _shared_expert(cfg, p, xf, ctx=None):
    """The shared expert, its weights as the dense MLP takes them under
    a mesh (``for_compute``: d_shared's split kept).  Under a mesh its
    output is a partial sum over "model", and so is the gate's
    gradient, which is pinned: the sigmoid's backward has no strategy
    for a partial sum, and DTensor would reduce-scatter it and then the
    block input's every other gradient to match."""
    g = xf @ for_compute(p["ws1"], 1)
    u = xf @ for_compute(p["ws3"], 1)
    sh = (act_fn(cfg.act)(g) * u) @ for_compute(p["ws2"], 0)
    gate = torch.sigmoid(constrain(xf @ for_compute(p["wsg"]),
                                   ("batch", None, None), ctx).float())
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
    if not is_dtensor(x):
        return moe_apply_global(cfg, p, x, ctx)
    out, aux = _on_token_shards(cfg, p, x)
    if cfg.moe.d_shared:
        out = out + _shared_expert(cfg, p, x, ctx)
    return out, aux


# ---------------------------------------------------------------------------
# the global mode on a rank's token shard and expert shard (module note)
# ---------------------------------------------------------------------------

def _register_ops() -> None:
    """``repro_torch::segment_mm`` and the product its backward takes
    for the weights, ``repro_torch::segment_mm_tn``, with their fake
    versions and FLOP formulas, once a process.

    ``segment_mm(a, b, offs)``: rows ``[offs[g-1], offs[g])`` of ``a``
    (M, K) times ``b[g]`` (G, K, N), ``offs`` ascending ends; rows from
    ``offs[-1]`` on come out zero.  ``segment_mm_tn(a, g, offs)``: the
    (G, K, N) products ``a[seg]^T g[seg]``.  Plain matmuls a segment,
    in any dtype; ``torch._grouped_mm`` computes the first only in bf16
    on the meta device and float32 at most on the CPU, and leaves the
    rows past ``offs[-1]`` and their gradient unwritten.  On a card the
    segment ends are read to the host, one sync a product.  The cost
    pass counts 2 M K N a call of either (``launch/hlo.py``)."""
    if hasattr(torch.ops.repro_torch, "segment_mm"):
        return
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::segment_mm", mutates_args=())
    def segment_mm(a: torch.Tensor, b: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
        out = a.new_zeros((a.shape[0], b.shape[2]))
        start = 0
        for g, end in enumerate(offs.tolist()):
            out[start:end] = a[start:end] @ b[g]
            start = end
        return out

    @segment_mm.register_fake
    def _(a, b, offs):
        return a.new_empty((a.shape[0], b.shape[2]))

    @torch.library.custom_op("repro_torch::segment_mm_tn", mutates_args=())
    def segment_mm_tn(a: torch.Tensor, g: torch.Tensor,
                      offs: torch.Tensor) -> torch.Tensor:
        out = a.new_zeros((offs.shape[0], a.shape[1], g.shape[1]))
        start = 0
        for e, end in enumerate(offs.tolist()):
            out[e] = a[start:end].t() @ g[start:end]
            start = end
        return out

    @segment_mm_tn.register_fake
    def _(a, g, offs):
        return a.new_empty((offs.shape[0], a.shape[1], g.shape[1]))

    def setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    def backward(ctx, grad):
        a, b, offs = ctx.saved_tensors
        grad = grad.contiguous()
        return (segment_mm(grad, b.transpose(1, 2), offs),
                segment_mm_tn(a, grad, offs), None)

    segment_mm.register_autograd(backward, setup_context=setup)

    @register_flop_formula(torch.ops.repro_torch.segment_mm)
    def _(a_shape, b_shape, *_, **__) -> int:
        return 2 * a_shape[0] * a_shape[1] * b_shape[2]

    @register_flop_formula(torch.ops.repro_torch.segment_mm_tn)
    def _(a_shape, g_shape, *_, **__) -> int:
        return 2 * a_shape[0] * a_shape[1] * g_shape[1]


_register_ops()
segment_mm = torch.ops.repro_torch.segment_mm


def _global_ranks(flat_e, row, before, E: int):
    """Each of a shard's assignments' rank among its expert's
    assignments over all tokens, in the global (B, S) order: its rank
    among the shard's assignments of that expert in the same row, plus
    ``before[row, e]``, that expert's assignments in every token before
    the row's first in the shard.  ``flat_e`` is in token order, so a
    stable sort by (row, expert) keeps each group in token order."""
    key = row * E + flat_e
    order = torch.argsort(key, stable=True)
    n = _counts(key, before.numel())
    starts = torch.cumsum(n, 0) - n
    ranks = torch.empty_like(flat_e)
    ranks[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[key[order]]
    return ranks + before.reshape(-1)[key]


def _route_shard(cfg: ModelConfig, x, router, we1, we3, we2, *,
                 n_tokens: int, prior, e0: int = 0):
    """The global dispatch's routed output for one token shard ``x``
    (Bl, Sl, D) of ``n_tokens``, on the experts ``[e0, e0 + El)`` whose
    weights ``we1``, ``we3``, ``we2`` hold (each on the rank's d_ff
    slice, or whole).  ``prior(cnt)`` takes the shard's assignments a
    row and expert, (Bl, E), and returns ``(before, total)``: each
    expert's assignments in all tokens before each row's first in the
    shard, (Bl, E), and over all tokens, (E,).  Returns ``(out, aux)``:
    the output of these experts (no shared expert), and this shard's
    part of the balance loss, whose sum over the token shards is the
    one-device loss."""
    m = cfg.moe
    Bl, Sl, D = x.shape
    Nl, K, E = Bl * Sl, m.top_k, m.n_experts
    El = we1.shape[0]
    xf = x.reshape(Nl, D)

    logits = (xf @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)            # (Nl, K)
    flat_e = top_e.reshape(Nl * K)
    tok = torch.arange(Nl, device=x.device).repeat_interleave(K)
    row = torch.div(tok, Sl, rounding_mode="floor")
    cnt = _counts(row * E + flat_e, Bl * E).reshape(Bl, E)
    before, total = prior(cnt)
    C = _capacity(cfg, n_tokens)
    keep = _global_ranks(flat_e, row, before, E) < C

    pe = probs.sum(dim=0) / n_tokens
    frac = total.float() / (n_tokens * K)
    aux = E * torch.sum(pe * frac) * m.router_aux_coef

    # the rank's experts first, each a segment in token order; the
    # assignments to other experts follow and come out zero
    local = torch.remainder(flat_e - e0, E)
    order = torch.argsort(local, stable=True)
    offs = torch.cumsum(_counts(local, E)[:El], 0)
    rows = xf[tok[order]]
    h = act_fn(cfg.act)(segment_mm(rows, we1, offs)) * \
        segment_mm(rows, we3, offs)
    eo = segment_mm(h, we2, offs)

    # each token's K outputs in ascending expert id, summed in order
    _, by_e = torch.sort(top_e, dim=-1)
    a = (torch.arange(Nl, device=x.device)[:, None] * K + by_e).reshape(-1)
    pos = torch.argsort(order)                  # each assignment's row
    contrib = eo[pos[a]] * top_p.reshape(-1)[a][:, None].to(x.dtype)
    per_tok = torch.where(keep[a][:, None], contrib, 0).reshape(Nl, K, D)
    out = torch.zeros((Nl, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + per_tok[:, j]
    return out.reshape(Bl, Sl, D), aux


def _flat_index(coord, dims, mesh) -> int:
    """The row-major index of a rank's coordinates on mesh ``dims``, the
    first outermost: its shard's index where those dims split one tensor
    dim (``sharding``'s module note)."""
    i = 0
    for j in dims:
        i = i * mesh.size(j) + coord[j]
    return i


def _on_token_shards(cfg: ModelConfig, p: dict, x):
    """The global mode's routed experts on DTensors, on each rank's token
    shard and expert shard through ``local_map`` (module note).  Each
    mesh dim takes one role:

    - "batch" or "seq", where ``x`` is split on its batch or positions:
      ``x`` keeps its shard; the router and the experts enter whole
      (FSDP's ``d_model`` shard gathered) and their gradients leave as
      partial sums, since a rank's covers its tokens alone;
    - "experts" or "d_ff", where the experts are split on their experts
      or d_ff dim: the experts keep that split, ``x`` and the router
      enter whole; the output, ``x``'s and the router's gradients leave
      as partial sums over the rank's experts or d_ff slice;
    - otherwise everything enters whole and each rank computes the same.

    The balance loss comes back as one replicated scalar: each token
    shard's part (``_route_shard``) is summed over the token dims, and
    on the expert dims only the rank at coordinate 0 carries it, so its
    gradient reaches the router once.  Returns (out, aux)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    R, P = Replicate(), Partial()
    # a role's placements: of (x, router, we1 and we3, we2) entering, of
    # their gradients, and of (out, aux) leaving
    table = {
        "batch": ((Shard(0), R, R, R), (Shard(0), P, P, P), (Shard(0), P)),
        "seq": ((Shard(1), R, R, R), (Shard(1), P, P, P), (Shard(1), P)),
        "experts": ((R, R, Shard(0), Shard(0)),
                    (P, P, Shard(0), Shard(0)), (P, P)),
        "d_ff": ((R, R, Shard(2), Shard(1)),
                 (P, P, Shard(2), Shard(1)), (P, P)),
        None: ((R, R, R, R), (R, R, R, R), (R, R)),
    }
    roles = []
    for px, pw in zip(x.placements, p["we1"].placements):
        roles.append("batch" if px == Shard(0) else
                     "seq" if px == Shard(1) else
                     "experts" if pw == Shard(0) else
                     "d_ff" if pw == Shard(2) else None)

    def col(k: int, i: int) -> tuple:
        return tuple(table[r][k][i] for r in roles)

    ins = tuple(col(0, i) for i in (0, 1, 2, 2, 3))
    grads = tuple(col(1, i) for i in (0, 1, 2, 2, 3))
    outs = (col(2, 0), col(2, 1))
    B, S = x.shape[:2]
    E = cfg.moe.n_experts
    dims = {r: [j for j, q in enumerate(roles) if q == r]
            for r in ("batch", "seq", "experts")}
    n_seq = math.prod(mesh.size(j) for j in dims["seq"])

    def fn(x, router, we1, we3, we2):
        coord = mesh.get_coordinate()
        Bl = x.shape[0]
        b0 = _flat_index(coord, dims["batch"], mesh) * Bl
        j0 = _flat_index(coord, dims["seq"], mesh)
        e0 = _flat_index(coord, dims["experts"], mesh) * we1.shape[0]

        def prior(cnt):
            # (B, n_seq, E): the counts in global (row, position block)
            # order, split as x's batch and positions
            every = DTensor.from_local(
                cnt[:, None], mesh, ins[0], run_check=False,
                shape=(B, n_seq, E), stride=(n_seq * E, E, 1)).full_tensor()
            flat = every.reshape(B * n_seq, E)
            before = torch.cumsum(flat, 0) - flat
            segs = (b0 + torch.arange(Bl, device=cnt.device)) * n_seq + j0
            return before[segs], flat.sum(dim=0)

        out, aux = _route_shard(cfg, x, router, we1, we3, we2,
                                n_tokens=B * S, prior=prior, e0=e0)
        if any(coord[j] for j, r in enumerate(roles)
               if r in ("experts", "d_ff")):
            aux = aux * 0
        return out, aux

    out, aux = local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads, device_mesh=mesh,
                         redistribute_inputs=True)(
        x, *(p[k] for k in ("router", "we1", "we3", "we2")))
    return out, aux.redistribute(mesh, [Replicate()] * mesh.ndim)
