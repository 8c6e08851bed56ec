"""Trees and dtypes between the reference's numpy trees and the port.

The reference hands its params and caches across as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, tree)``).  The port keeps the
same nesting, and flattens it in jax's tree-flatten order: dict keys
sorted.  bf16 arrives as numpy's ``bfloat16`` (from ``ml_dtypes``, which
this module does not import): it is recognised by its dtype name and
reinterpreted through a ``uint16`` view, so every bit is kept.

A whole train state ``{"params", "opt", "step"}`` crosses the same way
both ways (``tree_to_torch``, ``tree_to_numpy``): int32 ``step`` as a
0-d tensor, bf16 moments (``optim.adamw.for_arch``'s grok policy)
through their bits.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name (``"bfloat16"``), numpy dtype or torch dtype as a
    torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[np.dtype(name).name if not isinstance(name, str) else name]


def dtype_name(x) -> str:
    """The reference's dtype name of a tensor, array or dtype."""
    dt = getattr(x, "dtype", x)
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in jax's order (dict keys sorted) and the structure to
    rebuild the tree with ``tree_unflatten``."""
    if isinstance(tree, dict):
        leaves, spec = [], []
        for k in sorted(tree):
            sub, sspec = tree_flatten(tree[k])
            leaves.extend(sub)
            spec.append((k, sspec, len(sub)))
        return leaves, ("dict", spec)
    return [tree], None


def tree_unflatten(spec, leaves):
    leaves = list(leaves)
    if spec is None:
        return leaves[0]
    out, i = {}, 0
    for k, sspec, n in spec[1]:
        out[k] = tree_unflatten(sspec, leaves[i:i + n])
        i += n
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(l) for l in leaves])


def to_torch(arr, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 included) as a torch tensor, bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 comes back as its ``uint16`` bit pattern
    (callers compare bytes, not values)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tree_to_torch(tree, device="cpu"):
    """The reference's numpy tree (params or caches) as the port's."""
    return tree_map(lambda a: to_torch(a, device), tree)


def tree_to_numpy(tree):
    """The port's tree (params, caches or a train state) as numpy, bf16
    leaves as their ``uint16`` bit patterns (``to_numpy``)."""
    return tree_map(to_numpy, tree)
