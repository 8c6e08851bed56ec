"""The plain reference that decides ``correct``: the served model's
forward pass in float32 PyTorch (TF32 off), written from the
configuration file alone.  It imports nothing of the program.

It reads the weight tree the benchmark made (``weights.py``) and the
tokens the program served, and scores each served token against its
own logits, teacher-forced: the sequence is the prompt and the served
tokens, and the logits at positions ``P - 1 .. P + n - 2`` predict the
``n`` served tokens.  The model's equations, as the configuration file
states them: RMS norms scaled by ``1 + w``; q, k and v with biases;
RoPE by halves (text tokens give M-RoPE's three streams one position,
so its sections rotate as plain RoPE); causal GQA attention; a gated
SiLU MLP; for the MoE, a float32 softmax router over every expert, the
top ``num_experts_per_tok`` at their probabilities (not renormalised),
the file's capacity rule over each forward call's tokens (the prompt
is one call, each decode token is routed in a step of at most 8 tokens
and drops nothing), and the shared expert under its sigmoid gate.

The control (``fp8=True``) is the same pass with the operands of every
matmul rounded to float8 e4m3, each under one scale a tensor (a weight
matrix, an activation, q, k, v and the softmax's probabilities), as
cuBLASLt's and FlashAttention-3's fp8 paths take them: the precision
below the configuration's bf16 that a later change would be tempted to
serve in.  Accumulation, norms and softmax stay float32.

Work is layer by layer over every sampled sequence, the layer's weights
upcast once, and attention in blocks of query rows, so that the pass
fits beside the weights.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0


def _q8(t: torch.Tensor, dims=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (or for each slice over ``dims``), its largest magnitude at 448."""
    a = t.abs()
    amax = (a.amax() if dims is None else a.amax(dim=dims, keepdim=True))
    sc = amax.clamp(min=1e-12) / FP8_MAX
    return (t / sc).to(torch.float8_e4m3fn).to(torch.float32) * sc


class _Pass:
    def __init__(self, spec: dict, params: Dict, fp8: bool, block: int):
        self.s = spec
        self.p = params
        self.fp8 = fp8
        self.block = block

    # -- primitives ------------------------------------------------------
    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as an fp8 matmul takes it: one scale a tensor."""
        return _q8(t) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ w (in, out); w is already rounded under fp8."""
        return self.q(x) @ w

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight as (..., in, out) float32, rounded under fp8 with one
        scale a matrix (each expert's its own)."""
        w = w.to(torch.float32)
        return _q8(w, (-2, -1)) if self.fp8 and w.ndim >= 2 else w

    def rms(self, x, scale):
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                            + self.s["eps"])
        return x * (1.0 + scale.to(torch.float32))

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        T, _, dh = x.shape
        freqs = 1.0 / (self.s["theta"] ** (torch.arange(
            0, dh, 2, dtype=torch.float32, device=x.device) / dh))
        ang = torch.arange(T, dtype=torch.float32,
                           device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attend(self, q, k, v) -> torch.Tensor:
        """Causal GQA, q (T, H, dh), k and v (T, KV, dh) -> (T, H*dh)."""
        T, H, dh = q.shape
        KV = k.shape[1]
        G = H // KV
        q, k, v = self.q(q), self.q(k), self.q(v)
        qg = q.reshape(T, KV, G, dh).permute(1, 2, 0, 3)   # (KV,G,T,dh)
        kk = k.permute(1, 0, 2)[:, None]                     # (KV,1,T,dh)
        vv = v.permute(1, 0, 2)[:, None]
        out = torch.empty(T, H, dh, dtype=torch.float32, device=q.device)
        scale = dh ** -0.5
        for a in range(0, T, self.block):
            b = min(T, a + self.block)
            s = torch.matmul(qg[:, :, a:b], kk[..., :b, :].transpose(-1, -2))
            s = s * scale
            rows = torch.arange(a, b, device=q.device)[:, None]
            cols = torch.arange(b, device=q.device)[None]
            s = s.masked_fill(cols > rows, float("-inf"))
            o = torch.matmul(self.q(torch.softmax(s, dim=-1)),
                             vv[..., :b, :])
            out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, dh)
        return out.reshape(T, H * dh)

    # -- blocks ----------------------------------------------------------
    def layer_weights(self, l: int) -> Dict[str, torch.Tensor]:
        s = self.s
        D, H, KV, dh = s["D"], s["H"], s["KV"], s["dh"]
        a = self.p["groups"]["b0"]["attn"]
        f = self.p["groups"]["b0"]["ffn"]
        g = self.p["groups"]["b0"]
        W = {"ln1": g["ln1"][l], "ln2": g["ln2"][l],
             "wq": self.weight(a["wq"][l].reshape(D, H * dh)),
             "wk": self.weight(a["wk"][l].reshape(D, KV * dh)),
             "wv": self.weight(a["wv"][l].reshape(D, KV * dh)),
             "wo": self.weight(a["wo"][l].reshape(H * dh, D)),
             "bq": a["bq"][l].reshape(H * dh).to(torch.float32),
             "bk": a["bk"][l].reshape(KV * dh).to(torch.float32),
             "bv": a["bv"][l].reshape(KV * dh).to(torch.float32)}
        for name in f:
            W[name] = self.weight(f[name][l])
        return W

    def mlp(self, x, w1, w3, w2):
        h = torch.nn.functional.silu(self.mm(x, w1)) * self.mm(x, w3)
        return self.mm(h, w2)

    def moe(self, x: torch.Tensor, W: dict, P: int) -> torch.Tensor:
        m = self.s["moe"]
        E, K = m["E"], m["K"]
        probs = torch.softmax(self.mm(x, W["router"]), dim=-1)
        top_p, top_e = torch.topk(probs, K, dim=-1)          # (T, K)
        if m["norm_topk"]:
            top_p = top_p / top_p.sum(-1, keepdim=True)
        keep = torch.ones_like(top_e, dtype=torch.bool)
        keep[:P] = capacity_keep(top_e[:P], E, capacity(P, K, m["cf"], E))
        out = torch.zeros_like(x)
        for e in range(E):
            tok, j = torch.nonzero((top_e == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.mlp(x[tok], W["we1"][e], W["we3"][e], W["we2"][e])
            out.index_add_(0, tok, y * top_p[tok, j][:, None])
        if m["ds"]:
            gate = torch.sigmoid(self.mm(x, W["wsg"]))
            out = out + gate * self.mlp(x, W["ws1"], W["ws3"], W["ws2"])
        return out

    def block_apply(self, x: torch.Tensor, W: dict, P: int) -> torch.Tensor:
        s = self.s
        T = x.shape[0]
        h = self.rms(x, W["ln1"])
        q = (self.mm(h, W["wq"]) + W["bq"]).reshape(T, s["H"], s["dh"])
        k = (self.mm(h, W["wk"]) + W["bk"]).reshape(T, s["KV"], s["dh"])
        v = (self.mm(h, W["wv"]) + W["bv"]).reshape(T, s["KV"], s["dh"])
        o = self.attend(self.rope(q), self.rope(k), v)
        x = x + self.mm(o, W["wo"])
        h = self.rms(x, W["ln2"])
        if s["moe"] is None:
            return x + self.mlp(h, W["w1"], W["w3"], W["w2"])
        return x + self.moe(h, W, P)

    def run(self, samples: Sequence[dict]) -> List[torch.Tensor]:
        dev = self.p["emb"].device
        emb = self.p["emb"]
        hs, spans = [], []
        for smp in samples:
            toks = list(smp["prompt"]) + list(smp["tokens"][:-1])
            ids = torch.as_tensor(toks, dtype=torch.long, device=dev)
            hs.append(emb[ids].to(torch.float32))
            P = len(smp["prompt"])
            spans.append((P, P - 1, P - 1 + len(smp["tokens"])))
        for l in range(self.s["L"]):
            W = self.layer_weights(l)
            for i, (P, _, _) in enumerate(spans):
                hs[i] = self.block_apply(hs[i], W, P)
            del W
        head = self.p["emb"] if self.s["tied"] else self.p["lm_head"]
        head = self.weight(head.t())
        out = []
        for h, (_, a, b) in zip(hs, spans):
            out.append(self.mm(self.rms(h[a:b], self.p["final_ln"]), head))
        return out


def capacity(n_tokens: int, K: int, cf: float, E: int) -> int:
    """The configuration's capacity rule for one forward call of
    ``n_tokens`` tokens: ``floor(n K cf / E)`` rounded up to a multiple
    of 8, at least 8."""
    c = int(n_tokens * K * cf / E)
    return max(8, -(-c // 8) * 8)


def capacity_keep(top_e: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Which of one call's (T, K) assignments each expert keeps: its
    first ``C`` in token order."""
    T, K = top_e.shape
    flat = top_e.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, E)
    rank = torch.cumsum(onehot, dim=0).gather(1, flat[:, None])[:, 0] - 1
    return (rank < C).reshape(T, K)


def logits(spec: dict, params: Dict, samples: Sequence[dict], *,
           fp8: bool = False, block: int = 512) -> List[torch.Tensor]:
    """Each sample's (n, V) float32 logits at the positions that predict
    its ``n`` served tokens."""
    cuda = torch.backends.cuda.matmul
    old = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _Pass(spec, params, fp8, block).run(samples)
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def served_gaps(ref: Sequence[torch.Tensor],
                samples: Sequence[dict]) -> List[float]:
    """Each sample's widest gap by which a served token's reference
    logit lies below the reference's best at that position."""
    out = []
    for lg, smp in zip(ref, samples):
        t = torch.as_tensor(list(smp["tokens"]), dtype=torch.long,
                            device=lg.device)
        got = lg.gather(1, t[:, None])[:, 0]
        out.append(float((lg.max(dim=1).values - got).max()))
    return out


def control_samples(ctl: Sequence[torch.Tensor],
                    samples: Sequence[dict]) -> List[dict]:
    """The control in the program's place: at each position of the
    served sequences, the token the control puts first and the control's
    logit of it, in the samples' form, so that the harness's own
    comparison judges them as it judges the program's."""
    out = []
    for c, smp in zip(ctl, samples):
        top = c.max(dim=1)
        out.append({"rid": smp.get("rid"), "prompt": smp["prompt"],
                    "tokens": top.indices.tolist(),
                    "logits": top.values.tolist()})
    return out


def served_errors(ref, samples) -> List[torch.Tensor]:
    out = []
    for lg, smp in zip(ref, samples):
        t = torch.as_tensor(list(smp["tokens"]), dtype=torch.long,
                            device=lg.device)
        got = torch.as_tensor(list(smp["logits"]), dtype=torch.float32,
                              device=lg.device)
        out.append((lg.gather(1, t[:, None])[:, 0] - got).abs())
    return out


def _mean(errs: List[torch.Tensor]) -> Optional[float]:
    if not errs:
        return None
    return float(torch.cat(errs).mean())


def logit_error(ref: Sequence[torch.Tensor],
                samples: Sequence[dict]) -> Optional[float]:
    """The mean, over every served token of the samples, of the distance
    between the program's logit of that token (as its step returned it)
    and the reference's."""
    return _mean(served_errors(ref, samples))


def widest(gaps: Sequence[float]) -> Optional[float]:
    return max(gaps) if gaps else None
