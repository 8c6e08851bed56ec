"""Random weights made from ``--seed`` on the device, in the served type.

The tree is the one both sides read, laid out from the configuration
file alone: stacked layers under ``groups/b0``, as the port's parameter
tree has them (the harness checks every leaf's shape against the
port's definitions before serving).  All leaves are views into one
buffer, filled by one ``normal_`` from a ``torch.Generator`` on the
device and then scaled leaf by leaf: matrices by their fan-in to the
power -1/2, so that activations and logits stay near unit scale; the
norms' offsets from 1 and the biases by small constants, so that a
path that drops them shows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1          # (1 + scale) norms: scales around 1
BIAS_STD = 0.1


def layout(s: dict) -> Dict:
    """Leaf -> (shape, std) for the spec ``s`` (``yardstick.model_spec``)."""
    L, D, H, KV, dh, V = s["L"], s["D"], s["H"], s["KV"], s["dh"], s["V"]
    attn = {
        "bk": ((L, KV, dh), BIAS_STD), "bq": ((L, H, dh), BIAS_STD),
        "bv": ((L, KV, dh), BIAS_STD),
        "wk": ((L, D, KV, dh), D ** -0.5), "wo": ((L, H, dh, D),
                                                   (H * dh) ** -0.5),
        "wq": ((L, D, H, dh), D ** -0.5), "wv": ((L, D, KV, dh), D ** -0.5),
    }
    m = s["moe"]
    if m is None:
        F = s["F"]
        ffn = {"w1": ((L, D, F), D ** -0.5), "w2": ((L, F, D), F ** -0.5),
               "w3": ((L, D, F), D ** -0.5)}
    else:
        E, de, ds = m["E"], m["de"], m["ds"]
        ffn = {"router": ((L, D, E), D ** -0.5),
               "we1": ((L, E, D, de), D ** -0.5),
               "we2": ((L, E, de, D), de ** -0.5),
               "we3": ((L, E, D, de), D ** -0.5)}
        if ds:
            ffn.update({"ws1": ((L, D, ds), D ** -0.5),
                        "ws2": ((L, ds, D), ds ** -0.5),
                        "ws3": ((L, D, ds), D ** -0.5),
                        "wsg": ((L, D, 1), D ** -0.5)})
    tree = {"emb": ((V, D), D ** -0.5), "final_ln": ((D,), NORM_STD),
            "groups": {"b0": {"attn": attn, "ffn": ffn,
                              "ln1": ((L, D), NORM_STD),
                              "ln2": ((L, D), NORM_STD)}}}
    if not s["tied"]:
        tree["lm_head"] = ((V, D), D ** -0.5)
    return tree


def leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) in sorted-key order, the order the port
    flattens its trees in."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(leaves(v, path))
        else:
            out.append((path, v[0], v[1]))
    return out


def make(s: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weight tree of ``s`` from ``seed``: one buffer, one draw."""
    specs = leaves(layout(s))
    total = sum(_aligned(_numel(shape)) for _, shape, _ in specs)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    buf.normal_(generator=gen)
    tree: Dict = {}
    off = 0
    for path, shape, std in specs:
        n = _numel(shape)
        view = buf[off:off + n].view(shape)
        view.mul_(std)
        off += _aligned(n)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = view
    return tree


def flat(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(flat(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def _aligned(n: int, to: int = 256) -> int:
    """Leaves start on 512-byte boundaries, as allocations do."""
    return -(-n // to) * to


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
