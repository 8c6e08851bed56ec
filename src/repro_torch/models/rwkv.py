"""RWKV-6 (Finch) block: data-dependent-decay linear recurrence.

Twin of ``repro/models/rwkv.py`` (arXiv:2404.05892): ddlerp token shift
with low-rank data-dependent mixing, per-channel data-dependent decay
``w_t = exp(-exp(w0 + lora(x)))``, bonus ``u``, matrix-valued per-head
state S in R^{dk x dv}:

    y_t = r_t . (S_{t-1} + (u*k_t)^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

Prefill runs the reference's chunked formulation: a Python loop over
time chunks of ``c = min(chunk, T)`` tokens (``T % c == 0``, else
``ValueError``), each parallel within the chunk (an O(c^2) product per
head) with the state carried across chunks; decode (``T == 1``) is the
one-step recurrence.  No TPU kernel exists for RWKV, so this is plain
PyTorch in float32, on every device.  Under a mesh the time mix runs on
each rank's batch shard and local heads (``_on_local_heads``), since
DTensor has no strategy for its head split of a sharded width or its
chunked WKV.

The state tree (C.3 in ROADMAP.md): a layer's cache is
``{"mix": {"S", "tm_x"}, "cm_x"}``, the tree the reference's prefill and
decode produce and consume.  ``rwkv_state_defs`` gives the time-mix part
only; the reference's ``rwkv_state_defs`` also defines a ``cm_x`` under
``mix`` that no block reads or writes.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef, group_norm_heads
from repro_torch.sharding import constrain, is_dtensor


def rwkv_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    r = cfg.rwkv
    H = D // r.head_size
    lw, lm = r.decay_lora, r.mix_lora
    return {
        # time-mix
        "mu_x": ParamDef((D,), (None,), init="small"),
        "mu_rkvwg": ParamDef((5, D), (None, None), init="small"),
        "mix_a": ParamDef((D, 5 * lm), ("d_model", None), init="small"),
        "mix_b": ParamDef((5, lm, D), (None, "lora", None), init="small"),
        "w0": ParamDef((D,), (None,), init="decay"),
        "wa": ParamDef((D, lw), ("d_model", None), init="small"),
        "wb": ParamDef((lw, D), ("lora", None), init="small"),
        "u": ParamDef((H, r.head_size), (None, None), init="small"),
        "wr": ParamDef((D, D), ("d_model", "rec_width")),
        "wk": ParamDef((D, D), ("d_model", "rec_width")),
        "wv": ParamDef((D, D), ("d_model", "rec_width")),
        "wg": ParamDef((D, D), ("d_model", "rec_width")),
        "wo": ParamDef((D, D), ("rec_width", "d_model")),
        "ln_s": ParamDef((D,), (None,), init="ones"),
        "ln_b": ParamDef((D,), (None,), init="zeros"),
        # channel-mix
        "cmu_k": ParamDef((D,), (None,), init="small"),
        "cmu_r": ParamDef((D,), (None,), init="small"),
        "ck": ParamDef((D, cfg.d_ff), ("d_model", "d_ff")),
        "cv": ParamDef((cfg.d_ff, D), ("d_ff", "d_model")),
        "cr": ParamDef((D, D), ("d_model", "rec_width")),
    }


def rwkv_state_defs(cfg: ModelConfig, batch: int) -> dict:
    """The time-mix state: S and the last token (see the module note)."""
    D = cfg.d_model
    hs = cfg.rwkv.head_size
    H = D // hs
    return {
        "S": ParamDef((batch, H, hs, hs), ("batch", None, None, None),
                      dtype="float32"),
        "tm_x": ParamDef((batch, D), ("batch", None)),  # last token, time-mix
    }


def _shifted(x: torch.Tensor, mode: str, last: Optional[torch.Tensor]):
    """The previous token of every position: the carried ``last`` in
    decode; in prefill x shifted by one, position 0 taking ``last`` (or
    zeros without a state)."""
    if mode == "decode":
        return last[:, None]                               # (B,1,D)
    prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if last is not None:
        prev = prev.clone()
        prev[:, 0] = last
    return prev


def _ddlerp(x, sx, p):
    """Data-dependent lerp producing the 5 (r,k,v,w,g) mixed inputs."""
    lm = p["mix_b"].shape[1]
    base = x + sx * p["mu_x"]
    low = torch.tanh(torch.einsum("btd,dl->btl", base, p["mix_a"]))
    low = low.reshape(*low.shape[:-1], 5, lm)
    dyn = torch.einsum("btil,ild->ibtd", low, p["mix_b"])
    mus = p["mu_rkvwg"][:, None, None, :]
    return x[None] + sx[None] * (mus + dyn)               # (5, B, T, D)


def _wkv_chunk(S0, r, k, v, w, u):
    """One chunk of the wkv recurrence, parallel within the chunk.

    r,k,v,w: (B, T, H, hs) fp32; S0: (B, H, hs, hs) fp32.
    Returns (y (B,T,H,hs), S1).
    """
    B, T, H, hs = r.shape
    logw = torch.log(w)                                    # (B,T,H,hs), <0
    cum = torch.cumsum(logw, dim=1)                        # inclusive
    # contribution of the carried-in state: decay up to t-1 => cum - logw
    dec_in = torch.exp(cum - logw)
    y_state = torch.einsum("bthk,bhkv->bthv", r * dec_in, S0)
    # intra-chunk: pair (t, s<t) decays by exp(cum_{t-1} - cum_s), plus
    # the diagonal bonus u at s == t.  Both exp factors are shifted by the
    # chunk-midpoint cumulative decay and clamped to [-60, 60] so their
    # product never overflows: where a factor clamps the true decay is
    # exp(<-60) ~ 0 anyway.
    shift = cum[:, T // 2][:, None]                        # (B,1,H,hs)
    f_t = torch.exp(torch.clamp(cum - logw - shift, -60.0, 60.0))
    f_s = torch.exp(torch.clamp(shift - cum, -60.0, 60.0))
    att = torch.einsum("bthk,bshk->bhts", r * f_t, k * f_s)
    idx = torch.arange(T, device=r.device)
    att = torch.where((idx[None, :] < idx[:, None])[None, None], att, 0.0)
    diag = torch.einsum("bthk,bthk->bth", r, u[None, None] * k)
    y_intra = torch.einsum("bhts,bshv->bthv", att, v)
    y_intra = y_intra + diag[..., None] * v
    # state update: S1 = exp(cum_T) S0 + sum_s exp(cum_T - cum_s) k_s^T v_s
    dec_all = torch.exp(cum[:, -1])                        # (B,H,hs)
    S1 = dec_all[..., None] * S0 + torch.einsum(
        "bshk,bshv->bhkv", k * torch.exp(cum[:, -1:] - cum), v)
    return y_state + y_intra, S1


def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                  mode: str, state: Optional[dict], chunk: int = 128):
    """Returns (out, new_state {"S", "tm_x"}); the state is None in
    train.  On DTensors it runs on each rank's local heads
    (``_on_local_heads``); the head count is the projections' width over
    ``head_size``, so the same code runs on the whole width or a rank's
    heads."""
    if is_dtensor(x):
        return _on_local_heads(cfg, p, x, mode=mode, state=state,
                               chunk=chunk)
    B, T, _ = x.shape
    hs = cfg.rwkv.head_size
    H = p["wr"].shape[1] // hs

    sx = _shifted(x, mode, None if state is None else state["tm_x"]) - x
    xr, xk, xv, xw, xg = _ddlerp(x, sx, p)

    r = torch.einsum("btd,de->bte", xr, p["wr"])
    k = torch.einsum("btd,de->bte", xk, p["wk"])
    v = torch.einsum("btd,de->bte", xv, p["wv"])
    g = F.silu(torch.einsum("btd,de->bte", xg, p["wg"]))
    dw = torch.einsum("btd,dl->btl", torch.tanh(xw @ p["wa"]), p["wb"])
    w = torch.exp(-torch.exp((p["w0"] + dw).float()))
    w = w.reshape(B, T, H, hs)

    rf, kf, vf = (t.float().reshape(B, T, H, hs) for t in (r, k, v))
    u = p["u"].float()
    S0 = state["S"] if state is not None else torch.zeros(
        (B, H, hs, hs), dtype=torch.float32, device=x.device)
    if T == 1:
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, 0], vf[:, 0])
        y = torch.einsum("bhk,bhkv->bhv", rf[:, 0],
                         S0 + u[None, :, :, None] * kv)[:, None]
        S1 = w[:, 0][..., None] * S0 + kv
    else:
        c = min(chunk, T)
        if T % c:
            raise ValueError(f"rwkv prefill of {T} tokens: the length must "
                             f"be a multiple of the chunk {c}")
        ys, S1 = [], S0
        for i in range(T // c):
            sl = slice(i * c, (i + 1) * c)
            yi, S1 = _wkv_chunk(S1, rf[:, sl], kf[:, sl], vf[:, sl],
                                w[:, sl], u)
            ys.append(yi)
        y = torch.cat(ys, dim=1)

    y = group_norm_heads(y.to(x.dtype), p["ln_s"].reshape(H, hs),
                         p["ln_b"].reshape(H, hs), cfg.norm_eps)
    y = y.reshape(B, T, H * hs) * g
    out = torch.einsum("btd,de->bte", y, p["wo"])
    if mode == "train":
        return out, None
    return out, {"S": S1, "tm_x": x[:, -1]}


# the time mix's leaves; the channel mix's (``cmu_k``, ``cmu_r``, ``ck``,
# ``cv``, ``cr``) stay out of its local map.  Each split leaf with the
# dim that holds its heads: the four input projections' output, ``wo``'s
# input, and the per-channel leaves
_HEAD_DIM = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w0": 0, "wb": 1,
             "u": 0, "ln_s": 0, "ln_b": 0}
# the low-rank leaves, whole on every rank: the ddlerp's and the decay
# lora's input matrix
_WHOLE = ("mu_x", "mu_rkvwg", "mix_a", "mix_b", "wa")
_TIME_MIX = tuple(sorted(_HEAD_DIM)) + _WHOLE


def _on_local_heads(cfg: ModelConfig, p: dict, x, *, mode: str,
                    state: Optional[dict], chunk: int):
    """``rwkv_time_mix`` of DTensors on each rank's local heads, through
    ``local_map``.  Each mesh dim takes one role:

    - "batch", where ``x`` is split on its batch: ``x`` and the state
      keep their batch shard; every weight enters whole (FSDP's
      ``d_model`` shard gathered) and its gradient leaves as a partial
      sum;
    - "heads", where ``wr`` is split on its output and the heads split
      evenly over it (and the "heads" dims before it): ``wr``, ``wk``,
      ``wv`` and ``wg`` keep their output shard and ``wo`` its input
      shard; the per-channel leaves (``w0``, ``wb``'s output, ``u``,
      ``ln_s``, ``ln_b``) and ``S`` enter sliced to the local heads,
      which needs no collective; ``x``, ``tm_x`` and the low-rank leaves
      (``_WHOLE``) enter whole and their gradients leave as partial
      sums.  The output leaves as a partial sum of the local heads'
      ``wo`` products, which the block's pin reduces;
    - otherwise (a split sequence, a width that does not split by
      heads) everything enters whole and each rank computes the same.

    The new ``S`` leaves gathered over the heads' mesh dims, split over
    the batch alone: the reference's spec ("batch", None, None, None),
    so the cache tree and its placements stay the reference's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    H = cfg.d_model // cfg.rwkv.head_size
    roles, heads = [], 1
    for j, (px, pw) in enumerate(zip(x.placements, p["wr"].placements)):
        n = x.device_mesh.size(j)
        if px == Shard(0):
            roles.append("batch")
        elif pw == Shard(1) and H % (heads * n) == 0:
            heads *= n
            roles.append("heads")
        else:
            roles.append(None)

    def pl(batch=None, heads=None, grad=False):
        """Placements: ``batch`` on "batch" dims, ``heads`` on "heads"
        dims (a gradient: Partial where the value entered whole)."""
        out = []
        for r in roles:
            want = {"batch": batch, "heads": heads}.get(r)
            if want is None:
                want = Partial() if grad and r is not None else Replicate()
            out.append(want)
        return tuple(out)

    split = [Shard(_HEAD_DIM[k]) if k in _HEAD_DIM else None
             for k in _TIME_MIX]
    x_in, x_grad = pl(batch=Shard(0)), pl(batch=Shard(0), grad=True)
    s_pl = pl(batch=Shard(0), heads=Shard(1))
    ins = [x_in] + [pl(heads=d) for d in split]
    grads = [x_grad] + [pl(heads=d, grad=True) for d in split]
    args = [x] + [p[k] for k in _TIME_MIX]
    if state is not None:
        ins += [s_pl, x_in]
        grads += [s_pl, x_grad]
        args += [state["S"], state["tm_x"]]
    outs = (pl(batch=Shard(0), heads=Partial()),)
    if mode != "train":
        outs += (s_pl, x_in)

    def fn(x, *rest):
        st = None
        if len(rest) > len(_TIME_MIX):
            st = {"S": rest[-2], "tm_x": rest[-1]}
        out, new = rwkv_time_mix(cfg, dict(zip(_TIME_MIX, rest)), x,
                                 mode=mode, state=st, chunk=chunk)
        return (out,) if new is None else (out, new["S"], new["tm_x"])

    got = local_map(fn, out_placements=outs, in_placements=tuple(ins),
                    in_grad_placements=tuple(grads),
                    device_mesh=x.device_mesh,
                    redistribute_inputs=True)(*args)
    if mode == "train":
        return got[0], None
    out, S1, tm_x = got
    return out, {"S": S1.redistribute(S1.device_mesh, x_in), "tm_x": tm_x}


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                     mode: str, state: Optional[dict], ctx=None):
    """Returns (out, cm_x): the last token is the channel-mix state
    (None in train).

    ``v`` is pinned to ("batch", None, None) where the reference pins
    nothing: DTensor propagates placements op by op, so the product
    ``r * v`` with ``r`` split on d_model over "model" (``cr``'s
    ``rec_width``) left ``v``'s gradient split on d_model too, and the
    backward contracted it with ``cv`` into a partial sum over the
    whole d_ff, reduce-scattered a layer (ROADMAP C.7).  Pinned, ``v``
    is all-reduced once in the forward, its gradient all-gathered, and
    ``k``'s gradient stays on the rank's d_ff shard.  No-op on one
    device."""
    sx = _shifted(x, mode, None if state is None else state["cm_x"]) - x
    xk = x + sx * p["cmu_k"]
    xr = x + sx * p["cmu_r"]
    k = torch.square(F.relu(torch.einsum("btd,df->btf", xk, p["ck"])))
    v = constrain(torch.einsum("btf,fd->btd", k, p["cv"]),
                  ("batch", None, None), ctx)
    r = torch.sigmoid(torch.einsum("btd,de->bte", xr, p["cr"]))
    return r * v, (None if mode == "train" else x[:, -1])
