"""How well one training gradient is determined: the port's against the
reference's, beside the reference's against itself with its weights
moved by one float32 rounding.

Not a test (pytest collects ``test_*.py`` only): a probe of the
gradient norm at full width, on the CPU, from the reference's seed-0
weights and one seeded batch.  For the reference, the port (the same
weights, copied) and the reference again with every float weight
scaled by ``1 + 1e-7 N(0, 1)``, it prints the loss and the float32
global gradient norm, then the leaves with the largest gradients: each
one's norm in the three runs and its largest difference from the
reference over the reference's largest entry.  Where the perturbed
reference moves as far as the port does, the model at this depth
amplifies rounding and a gap between the packages is no fault of the
port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/grad_conditioning.py \\
        --arch qwen2-0.5b --layers 24 --batch 2 --seq 64 --dtype float32

At full width qwen2-0.5b's embedding alone is 136M params: the 24-layer
float32 run above peaks near 15 GB of host memory, so keep the batch
small.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.models import lm
from repro.models import transformer as T
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.models import lm as plm


def _norms(leaves):
    return [float(np.sqrt(np.sum(x.astype(np.float64) ** 2)))
            for x in leaves]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--top", type=int, default=6)
    a = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(a.arch), n_layers=a.layers,
                              dtype=a.dtype)
    pcfg = dataclasses.replace(port_config(a.arch), n_layers=a.layers,
                               dtype=a.dtype)
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab, (a.batch, a.seq + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def ref(p):
        (loss, _), g = jax.value_and_grad(
            lambda p: lm.loss_fn(cfg, p, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
            has_aux=True)(p)
        return float(loss), [np.asarray(x.astype(jnp.float32))
                             for x in jax.tree.leaves(g)]

    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    runs = {"reference": ref(params)}
    tp = interop.tree_map(
        lambda x: x.to(torch.bfloat16) if a.dtype == "bfloat16" and
        x.dtype == torch.float32 else x,
        interop.tree_to_torch(jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)), params)))
    (loss, _), g = plm.value_and_grad(
        pcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    runs["port"] = (float(loss), [x.float().numpy()
                                  for x in interop.tree_leaves(g)])
    rng = np.random.default_rng(1)
    moved = jax.tree.map(
        lambda x: (x.astype(jnp.float32) * (1 + 1e-7 * rng.standard_normal(
            x.shape).astype(np.float32))).astype(x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
    runs["reference, weights x (1 + 1e-7 N(0,1))"] = ref(moved)
    want = runs["reference"][1]
    out = {}
    print(f"{a.arch} layers={a.layers} {a.dtype} batch {a.batch} x {a.seq}")
    for label, (loss, leaves) in runs.items():
        n = _norms(leaves)
        out[label] = {"loss": loss, "grad_norm": float(np.sqrt(sum(
            x * x for x in n)))}
        print(f"  {label}: loss {loss:.6f} grad norm "
              f"{out[label]['grad_norm']:.6g}")
    for i in np.argsort(_norms(want))[::-1][:a.top]:
        top = max(float(np.abs(want[i]).max()), 1e-30)
        print(f"  {names[i]}: " + "; ".join(
            f"{label} {_norms([lv[i]])[0]:.6g}" + (
                "" if label == "reference" else
                f" (max |d| / max {np.abs(lv[i] - want[i]).max() / top:.3g})")
            for label, (_, lv) in runs.items()))
    return out


if __name__ == "__main__":
    main()
