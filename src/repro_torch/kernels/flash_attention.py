"""Forward attention for prefill: causal, sliding-window or bidirectional
GQA, with an optional logit soft cap.

Twin of ``repro/kernels/flash_attention.py``.  ``flash_attention(q, k, v)``
takes ``q`` (B, S, H, dh) and ``k``, ``v`` (B, S, KV, dh), bf16 or float32,
in the reference's layout, and returns (B, S, H, dh) in the input dtype.
S may have any length: the reference's ``S % block == 0`` is not carried
over.

On CUDA tensors it launches a CUDA C++ kernel of
``csrc/flash_attention.cu`` on the current stream, or raises: in bf16 the
warp-specialised TMA and wgmma kernel, one launch per ``MAX_PLAN_TILES``
q tiles, whose tensor maps (``tensor_map_spec``), q-tile order and live
k-tile ranges (``launch_plans``) are planned here in plain Python and
handed to the launch, so that the CPU tests reach the plan that runs; in
float32 the CUDA-core kernel, one launch.  On CPU tensors it runs the
plain PyTorch version, ``attention_chunked``,
which is the reference model's own prefill attention (online softmax over
(q-chunk, kv-chunk) tiles, the running output in the input dtype).  So on
the CPU the port's model keeps the reference's order of operations.
Nothing falls back from the card to the plain version.
``flash_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain version: the reference model's chunked online-softmax attention
# ---------------------------------------------------------------------------

def _attend_tile(q, k, v, bias, scale, cap):
    # q: (B,cq,H,dh) k/v: (B,ck,KV,dh) bias: (cq,ck) fp32
    B, cq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, cq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    s = s + bias[None, None, None]
    m = torch.amax(s, dim=-1)                              # (B,KV,G,cq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return (o.reshape(B, cq, H, dh),
            m.permute(0, 3, 1, 2).reshape(B, cq, H),
            l.permute(0, 3, 1, 2).reshape(B, cq, H))


def _combine(acc, o, m, l):
    o0, m0, l0 = acc
    m1 = torch.maximum(m0, m)
    a0 = torch.exp(m0 - m1)
    a1 = torch.exp(m - m1)
    o1 = o0 * a0[..., None].to(o0.dtype) + o * a1[..., None].to(o.dtype)
    return o1, m1, l0 * a0 + l * a1


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      chunk_q: int = 1024, chunk_k: int = 1024,
                      scale: Optional[float] = None,
                      logit_cap: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,dh); k,v: (B,S,KV,dh) -> (B,S,H,dh). GQA attention.

    Every (q-chunk, kv-chunk) tile is computed and masked, as the
    reference's scanned path does; the running output stays in the input
    dtype between tiles."""
    B, S, H, dh = q.shape
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    cq, ck = min(chunk_q, S), min(chunk_k, S)
    if S % cq or S % ck:
        cq = ck = S   # odd lengths (tests/short prompts): one full tile
    nq, nk = S // cq, S // ck
    dev = q.device
    outs = []
    for qi in range(nq):
        q0 = qi * cq
        qb = q[:, q0:q0 + cq]
        acc = (torch.zeros((B, cq, H, dh), dtype=q.dtype, device=dev),
               torch.full((B, cq, H), NEG_INF, dtype=torch.float32,
                          device=dev),
               torch.zeros((B, cq, H), dtype=torch.float32, device=dev))
        qi_idx = q0 + torch.arange(cq, device=dev)[:, None]
        for ki in range(nk):
            k0 = ki * ck
            kb, vb = k[:, k0:k0 + ck], v[:, k0:k0 + ck]
            ki_idx = k0 + torch.arange(ck, device=dev)[None, :]
            m = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                m &= ki_idx <= qi_idx
            if window is not None:
                m &= ki_idx > qi_idx - window
            bias = torch.where(m, 0.0, NEG_INF).float()
            acc = _combine(acc, *_attend_tile(qb, kb, vb, bias, scale,
                                              logit_cap))
        o, _, l = acc
        outs.append(o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# the bf16 kernel's host plan (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

Q_ROWS = 128           # kFaBQ: q rows of a CTA, two consumers of 64
K_ROWS = 64            # kFaBK: keys of a k tile
MAX_PLAN_TILES = 96    # kFaMaxTiles: the plan stays a kernel parameter


class TmaSpec(ctypes.Structure):
    """``TmaSpec`` of csrc/flash_attention.cu: what the launch hands
    ``cuTensorMapEncodeTiled`` for one of q, k, v."""
    _fields_ = [("base", ctypes.c_uint64), ("dims", ctypes.c_uint64 * 4),
                ("strides", ctypes.c_uint64 * 3),
                ("box", ctypes.c_uint32 * 4), ("swizzle", ctypes.c_uint32)]


class FaTile(ctypes.Structure):
    """``FaTile`` of csrc/flash_attention.cu: one q tile of a launch and
    the live k tiles of its CTA and of each consumer's 64 rows."""
    _fields_ = [("qt", ctypes.c_int32), ("lo", ctypes.c_int32),
                ("hi", ctypes.c_int32), ("c_lo", ctypes.c_int32 * 2),
                ("c_hi", ctypes.c_int32 * 2)]


class FaPlan(ctypes.Structure):
    """``FaPlan`` of csrc/flash_attention.cu, passed by value as a
    ``__grid_constant__`` parameter: CTA i of the launch runs tile
    ``i // (H * B)``, head ``i % (H * B) % H``, batch ``i % (H * B) // H``."""
    _fields_ = [("n", ctypes.c_int32), ("tile", FaTile * MAX_PLAN_TILES)]


def swizzle_bytes(dh: int) -> int:
    """The swizzle span of a bf16 tile row: 32 B at dh 16, 64 B at dh 32,
    128 B (a box of 64 columns) from dh 64 on."""
    return 128 if dh >= 64 else 2 * dh


def tensor_map_spec(t: torch.Tensor, rows: int) -> TmaSpec:
    """The 4-D tensor map of a (B, S, heads, dh) bf16 tensor read through
    its strides: dims (dh, heads, S, B), the byte strides of heads, S and
    B, a box of one swizzle span x 1 head x ``rows`` rows x 1 batch."""
    B, S, n, dh = t.shape
    sb, ss, sh = t.stride()[:3]
    sw = swizzle_bytes(dh)
    isz = t.element_size()
    return TmaSpec(base=t.data_ptr(), dims=(dh, n, S, B),
                   strides=(sh * isz, ss * isz, sb * isz),
                   box=(sw // isz, 1, rows, 1), swizzle=sw)


def live_k_tiles(r0: int, rows: int, S: int, causal: bool,
                 window: Optional[int]) -> Tuple[int, int]:
    """The k tiles [lo, hi) that q rows [r0, r0 + rows) need: none wholly
    above the diagonal or wholly before the window, none for rows past
    ``S``.  The one definition of the live range: the kernel reads these
    from its plan and computes none itself."""
    nk = -(-S // K_ROWS)
    lo = max(0, r0 - window + 1) // K_ROWS if window else 0
    hi = min(nk, min(r0 + rows - 1, S - 1) // K_ROWS + 1) if causal else nk
    if r0 >= S or hi < lo:
        hi = lo
    return lo, hi


def q_tile_order(S: int, causal: bool, window: Optional[int]) -> List[int]:
    """The q tiles in launch order: the most live k tiles first (under a
    causal mask the last tile), the later tile first among equals."""
    nq = -(-S // Q_ROWS)

    def weight(qt):
        lo, hi = live_k_tiles(qt * Q_ROWS, Q_ROWS, S, causal, window)
        return hi - lo

    return sorted(range(nq), key=lambda qt: (-weight(qt), -qt))


def launch_plans(S: int, causal: bool,
                 window: Optional[int]) -> List[FaPlan]:
    """The launches of one call: the q tiles in ``q_tile_order``, at most
    ``MAX_PLAN_TILES`` a launch, each with the live k tiles of its CTA and
    of each consumer's 64 rows."""
    plans = []
    order = q_tile_order(S, causal, window)
    for i in range(0, len(order), MAX_PLAN_TILES):
        chunk = order[i:i + MAX_PLAN_TILES]
        pl = FaPlan(n=len(chunk))
        for t, qt in zip(pl.tile, chunk):
            r0 = qt * Q_ROWS
            t.qt = qt
            t.lo, t.hi = live_k_tiles(r0, Q_ROWS, S, causal, window)
            for c in range(Q_ROWS // 64):
                t.c_lo[c], t.c_hi[c] = live_k_tiles(r0 + 64 * c, 64, S,
                                                    causal, window)
        plans.append(pl)
    return plans


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _kernels() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_f32_launch.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
            f32, f32, vp]
        lib.flash_attention_f32_launch.restype = i32
        spec = ctypes.POINTER(TmaSpec)
        lib.flash_attention_bf16_launch.argtypes = [
            spec, spec, spec, vp, vp, ctypes.POINTER(FaPlan), i32, i32,
            i32, i32, i32, i32, i32, f32, f32, vp]
        lib.flash_attention_bf16_launch.restype = i32
        lib._typed = True
    return lib


def _check_strides(t: torch.Tensor, name: str) -> None:
    """The kernel reads through the strides: the last dim dense, the base
    and every stride 16-byte aligned (any contiguous tensor is)."""
    isz = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (st * isz) % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name}: the kernel needs a dense last dim and "
                         f"16-byte aligned strides, got {t.stride()}")


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B,S,H,dh) and "
                         f"(B,S,KV,dh) twice")
    B, S, H, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, dh) or \
            H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not agree (KV must divide H)")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v lie on several devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_cap: Optional[float] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,dh); k,v: (B,S,KV,dh) -> (B,S,H,dh).

    ``chunk`` is the plain version's tile (the model passes its
    ``attn_chunk``, as the reference model does); the kernel has its own
    tiles."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 chunk_q=chunk, chunk_k=chunk, scale=scale,
                                 logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, S, H, dh = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes bf16 or float32, not "
                         f"{q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes d_head in {HEAD_DIMS}, "
                         f"not {dh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_cap is not None and logit_cap <= 0:
        raise ValueError(f"logit_cap must be > 0, got {logit_cap}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_strides(t, name)
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    KV = k.shape[2]
    win = 0 if window is None else window
    cap = 0.0 if logit_cap is None else float(logit_cap)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        specs = [tensor_map_spec(t, rows)
                 for t, rows in ((q, Q_ROWS), (k, K_ROWS), (v, K_ROWS))]
        o_strides = (ctypes.c_longlong * 3)(*out.stride()[:3])
        for pl in launch_plans(S, causal, window):
            build.check(_kernels().flash_attention_bf16_launch(
                *(ctypes.byref(sp) for sp in specs), out.data_ptr(),
                ctypes.cast(o_strides, ctypes.c_void_p), ctypes.byref(pl),
                B, S, H, KV, dh, int(causal), win, float(scale), cap,
                stream), "flash_attention")
            flash_attention.launches += 1
        return out
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    table = (ctypes.c_longlong * 12)(*strides)
    build.check(_kernels().flash_attention_f32_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.cast(table, ctypes.c_void_p), B, S, H, KV, dh,
        int(causal), win, float(scale), cap, stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
