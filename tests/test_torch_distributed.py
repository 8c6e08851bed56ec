"""The port's sharded training on the CPU, twin of
``tests/test_distributed.py``: the step runs as DTensor over a gloo group
of CPU processes (``torch_ranks.run_ranks``, one subprocess a rank), on a
(4, 2) ("data", "model") mesh placed by ``train_specs``.  The reference's
own sharded step fails on this jax (``with_sharding_constraint`` rejects
``make_mesh``'s Explicit axes), so the port's (4, 2) step is held against
the reference's single-device step, at the reference's bars.  The meshes
of ``launch/mesh.py`` are built under PyTorch's fake process group, in a
subprocess too: no group is ever started in the test process."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import SRC, run_ranks  # noqa: E402

# the reference's bars (tests/test_distributed.py)
DLOSS, DPARAM = 2e-4, 5e-3

PARITY_CHILD = r"""
import dataclasses
import numpy as np
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_flatten, tree_unflatten
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import train_specs
from repro_torch.models import lm, transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import TRAIN_RULES, ShardCtx, distribute_tree, full

cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3-8b")),
                          dtype="float32")
opt = AdamW(lr=1e-3, weight_decay=0.0)
inp = np.load(os.environ["INPUTS"])
spec = tree_flatten(T.param_defs(cfg))[1]
n = len([k for k in inp.files if k.startswith("p")])
params = tree_unflatten(spec, [torch.from_numpy(inp[f"p{i}"])
                               for i in range(n)])
state = {"params": params, "opt": opt.init(params),
         "step": torch.zeros((), dtype=torch.int32)}
batch = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")}
B, S = batch["tokens"].shape

mesh = make_dev_mesh(4, 2, device_type="cpu")
cell, _ = train_specs(cfg, ShapeCfg("t", S, B, "train"), mesh, opt)
state_sh, batch_sh = cell.shardings
state_d = distribute_tree(state, state_sh)
batch_d = distribute_tree(batch, batch_sh)
step = lm.make_train_step(cfg, opt, ctx=ShardCtx(mesh, TRAIN_RULES))
new, m = step(state_d, batch_d)

before = [tuple(p.placements) for p in tree_flatten(state_d["params"])[0]]
after = [tuple(p.placements) for p in tree_flatten(new["params"])[0]]
leaves = [full(p).numpy() for p in tree_flatten(new["params"])[0]]
if RANK == 0:
    np.savez(os.environ["OUTPUTS"], *leaves)
done({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
      "step": int(full(new["step"])),
      "sharded_leaves": sum(any(p.is_shard() for p in pl) for pl in before),
      "placements_kept": before == after,
      "batch": [str(p) for p in batch_d["tokens"].placements]})
"""


def _reference_step(tmp_path):
    """The reference's single-device step on llama3-8b at smoke size,
    float32 (``test_sharded_train_step_matches_single_device``'s
    inputs), with its inputs written for the child."""
    from repro.configs import get_config, reduce_for_smoke
    from repro.models import lm, transformer as T
    from repro.optim.adamw import AdamW
    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3-8b")),
                              dtype="float32")
    opt = AdamW(lr=1e-3, weight_decay=0.0)
    key = jax.random.PRNGKey(0)
    params = T.tree_init(T.param_defs(cfg), cfg, key)
    params = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    B, S = 8, 32
    batch = {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab),
             "labels": jax.random.randint(key, (B, S), 0, cfg.vocab)}
    new, metrics = jax.jit(lm.make_train_step(cfg, opt))(state, batch)
    inputs = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(inputs, tokens=np.asarray(batch["tokens"], np.int32),
             labels=np.asarray(batch["labels"], np.int32),
             **{f"p{i}": np.asarray(p)
                for i, p in enumerate(jax.tree.leaves(params))})
    return inputs, new, metrics


def test_sharded_train_step_matches_single_device_reference(tmp_path):
    """llama3-8b at smoke size, float32, B=8, S=32, AdamW(lr=1e-3,
    weight_decay=0): the port's step on a (4, 2) gloo mesh against the
    reference's single-device step, dloss < 2e-4 and dparam < 5e-3 over
    every param leaf; the params really are sharded and keep their
    placements through the update."""
    inputs, ref, ref_m = _reference_step(tmp_path)
    outputs = os.path.join(str(tmp_path), "outputs.npz")
    out = run_ranks(PARITY_CHILD, 8, tmp_path,
                    env={"INPUTS": inputs, "OUTPUTS": outputs})
    assert abs(out["loss"] - float(ref_m["loss"])) < DLOSS, out
    assert math.isclose(out["grad_norm"], float(ref_m["grad_norm"]),
                        rel_tol=1e-4)
    assert out["step"] == 1
    assert out["sharded_leaves"] > 0 and out["placements_kept"]
    assert out["batch"] == ["S(0)", "R"]       # batch over "data"
    got = np.load(outputs)
    want = jax.tree.leaves(ref["params"])
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        d = float(np.max(np.abs(got[f"arr_{i}"] - np.asarray(w))))
        assert d < DPARAM, (i, d)


FAMILIES_CHILD = r"""
import dataclasses
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_leaves
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import train_specs
from repro_torch.launch.train import build_state
from repro_torch.models import lm, transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import TRAIN_RULES, ShardCtx, distribute_tree, full

mesh = make_dev_mesh(2, 2, device_type="cpu")
opt = AdamW(lr=1e-3, weight_decay=0.0)
out = {}
for arch, extra in (("recurrentgemma-2b", {"remat": "block"}),
                    ("rwkv6-1.6b", {}), ("qwen2-moe-a2.7b", {}),
                    ("qwen2-moe-a2.7b", {"moe_dispatch": "grouped"})):
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="float32", **extra)
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    state = build_state(cfg, opt, 0, "cpu")
    cell, _ = train_specs(cfg, ShapeCfg("t", 32, 8, "train"), mesh, opt)
    ctx = ShardCtx(mesh, TRAIN_RULES)
    state_d = distribute_tree(state, cell.shardings[0])
    batch_d = distribute_tree(batch, cell.shardings[1])
    new, m = lm.make_train_step(cfg, opt, ctx=ctx)(state_d, batch_d)
    plain, pm = lm.make_train_step(cfg, opt)(state, batch)
    # each leaf's gradient in float64, where the sharded route's
    # reordered sums leave at most ~5e-6 of a leaf's largest entry (in
    # float32 they leave up to ~5e-4 on recurrentgemma, 8e-5 on RWKV)
    cfg = dataclasses.replace(cfg, dtype="float64")
    params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
    grads = lm.value_and_grad(
        cfg, distribute_tree(params, cell.shardings[0]["params"]),
        batch_d, ctx=ctx)[1]
    want = lm.value_and_grad(cfg, params, batch)[1]
    out[arch + "".join(f"-{v}" for v in extra.values())] = {
        "dloss": abs(float(m["loss"]) - float(pm["loss"])),
        "dparam": max(float((full(a) - b).abs().max()) for a, b in zip(
            tree_leaves(new["params"]), tree_leaves(plain["params"]))),
        "grad_norm": [float(m["grad_norm"]), float(pm["grad_norm"])],
        "dgrad": [[float((full(a) - b).abs().max()), float(b.abs().max())]
                  for a, b in zip(tree_leaves(grads), tree_leaves(want))]}
done(out)
"""


def test_sharded_families_match_their_plain_step(tmp_path):
    """The other block kinds on a (2, 2) gloo mesh, at smoke size in
    float32, against the port's own one-device step: the hybrid under
    remat (rg_lru on the width's shards, flash with its heads
    replicated since its one KV head cannot split), RWKV's time mix on
    each rank's local heads (4 heads of 16, 2 a rank), the global MoE
    on each rank's tokens and local experts (``moe._on_token_shards``;
    its 4 experts split over "model"), the grouped MoE with its
    constraints.  Besides
    the step's loss and params, the step's grad norm is within 1e-4
    relative, and every leaf's gradient (``lm.value_and_grad``, in
    float64) within 2e-5 of its largest entry: the first AdamW step
    moves a param by about lr x warm-up = 1e-5 whatever its gradient,
    so dparam alone would not see a gradient that lost a rank's partial
    sum."""
    out = run_ranks(FAMILIES_CHILD, 4, tmp_path)
    assert len(out) == 4
    for name, d in out.items():
        assert d["dloss"] < DLOSS and d["dparam"] < DPARAM, (name, d)
        assert math.isclose(*d["grad_norm"], rel_tol=1e-4), (name, d)
        for i, (err, scale) in enumerate(d["dgrad"]):
            assert err <= 2e-5 * scale, (name, i, err, scale)


MOE_CHILD = r"""
import dataclasses
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_leaves
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import train_specs
from repro_torch.launch.train import build_state
from repro_torch.models import lm, moe as M, transformer as T
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import TRAIN_RULES, ShardCtx, distribute_tree, full

mesh = make_dev_mesh(2, 2, device_type="cpu")
model0 = mesh.get_coordinate()[1] == 0
cfg = reduce_for_smoke(get_config("qwen2-moe-a2.7b"))
E = int(os.environ["EXPERTS"])
cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
    cfg.moe, n_experts=E, capacity_factor=1.0))
B, S = 8, 32
C = M._capacity(cfg, B * S)
# each layer's assignments an expert in the plain step, of which it
# keeps the first C (the reference's rule, from its routing), and the
# kept ones of the sharded step, read from its own ranks, on the ranks
# of "model" coordinate 0 (the others repeat them), summed over "data"
kept = {"plain": [], "sharded": [], "shard_counts": []}
plain_global, ranks = M.moe_apply_global, M._global_ranks


def spy_plain(cfg, p, x, ctx=None):
    xf = x.reshape(-1, x.shape[-1])
    top_e = torch.topk(torch.softmax((xf @ p["router"]).float(), -1),
                       cfg.moe.top_k, dim=-1)[1].reshape(-1)
    kept["plain"].append(M._counts(top_e, E).tolist())
    return plain_global(cfg, p, x, ctx)


def spy_ranks(flat_e, row, before, n):
    got = ranks(flat_e, row, before, n)
    kept["sharded"].append(M._counts(flat_e[got < C], E))
    kept["shard_counts"].append(M._counts(flat_e, E))
    return got


M.moe_apply_global, M._global_ranks = spy_plain, spy_ranks
opt = AdamW(lr=1e-3, weight_decay=0.0)
g = torch.Generator().manual_seed(5)
batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
state = build_state(cfg, opt, 0, "cpu")
cell, _ = train_specs(cfg, ShapeCfg("t", S, B, "train"), mesh, opt)
ctx = ShardCtx(mesh, TRAIN_RULES)
state_d = distribute_tree(state, cell.shardings[0])
batch_d = distribute_tree(batch, cell.shardings[1])
new, m = lm.make_train_step(cfg, opt, ctx=ctx)(state_d, batch_d)
plain, pm = lm.make_train_step(cfg, opt)(state, batch)
plain_counts = list(kept["plain"])
sharded = torch.stack(kept["sharded"]) * model0
dist.all_reduce(sharded)
counts = [c.tolist() for c in kept["shard_counts"]] if model0 else []
every = [None] * WORLD
dist.all_gather_object(every, counts)
cfg64 = dataclasses.replace(cfg, dtype="float64")
params = T.tree_init(T.param_defs(cfg64), cfg64, 0, "cpu")
grads = lm.value_and_grad(
    cfg64, distribute_tree(params, cell.shardings[0]["params"]),
    batch_d, ctx=ctx)[1]
want = lm.value_and_grad(cfg64, params, batch)[1]
done({"dloss": abs(float(m["loss"]) - float(pm["loss"])),
      "dparam": max(float((full(a) - b).abs().max()) for a, b in zip(
          tree_leaves(new["params"]), tree_leaves(plain["params"]))),
      "grad_norm": [float(m["grad_norm"]), float(pm["grad_norm"])],
      "dgrad": [[float((full(a) - b).abs().max()), float(b.abs().max())]
                for a, b in zip(tree_leaves(grads), tree_leaves(want))],
      "kept": sharded.tolist(), "plain_counts": plain_counts, "C": C,
      "shard_counts": [c for c in every if c],
      "placement": [str(p) for p in state_d["params"]["groups"]["b0"][
          "ffn"]["we1"].placements]})
"""


@pytest.mark.parametrize("experts,placement", [
    (4, ["S(2)", "S(1)"]), (3, ["S(2)", "S(3)"])], ids=["experts", "d_ff"])
def test_global_moe_on_token_shards_keeps_the_plain_steps_assignments(
        tmp_path, experts, placement):
    """qwen2-moe-a2.7b at smoke size, float32, capacity factor 1, on
    a (2, 2) gloo mesh: the global MoE on each rank's 4 x 32 tokens and
    its shard of the experts (``moe._on_token_shards``), with 4 experts
    split over "model" or 3, whose d_expert 32 splits instead.  Its
    train step against the plain step at the families test's bars
    (dloss, dparam, grad norm rel 1e-4, each leaf's float64 gradient
    within 2e-5 of its largest entry), and each layer's kept
    assignments an expert equal to the plain step's first C: the two
    data shards route unevenly, and some experts take more than C and
    drop while others take fewer, so a shard that took its own share of
    C, or ranked its assignments from zero, would keep others."""
    out = run_ranks(MOE_CHILD, 4, tmp_path, env={"EXPERTS": str(experts)})
    assert out["placement"] == placement, out["placement"]
    assert out["dloss"] < DLOSS and out["dparam"] < DPARAM, out
    assert math.isclose(*out["grad_norm"], rel_tol=1e-4), out
    for i, (err, scale) in enumerate(out["dgrad"]):
        assert err <= 2e-5 * scale, (i, err, scale)
    C, counts = out["C"], out["plain_counts"]
    assert len(out["kept"]) == len(counts) == 2, out  # the 2 layers
    assert out["kept"] == [[min(c, C) for c in row] for row in counts], out
    flat = [c for row in counts for c in row]
    assert max(flat) > C > min(flat), (C, counts)  # drops, and room
    first, second = out["shard_counts"]           # the data shards
    assert first != second, out                   # routed unevenly


RWKV_SERVE_CHILD = r"""
import dataclasses
import numpy as np
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_map
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import serve_specs
from repro_torch.models import lm, rwkv as R, transformer as T
from repro_torch.sharding import (SERVE_RULES, ShardCtx, distribute_tree,
                                  full, is_dtensor)

# the widths each call of the time mix on plain tensors computes with
widths = []
whole = R.rwkv_time_mix


def spy(cfg, p, x, **kw):
    if not is_dtensor(x):
        widths.append(list(p["wr"].shape))
    return whole(cfg, p, x, **kw)


R.rwkv_time_mix = spy
cfg = dataclasses.replace(reduce_for_smoke(get_config("rwkv6-1.6b")),
                          dtype="float32")
B, P = 4, 32
params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
prompt = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (B, P)).astype(np.int32))
mesh = make_dev_mesh(2, 2, device_type="cpu")
ctx = ShardCtx(mesh, SERVE_RULES)
specs = {k: serve_specs(cfg, ShapeCfg(k, P, B, k), mesh, k)
         for k in ("prefill", "decode")}
p_d = distribute_tree(params, specs["prefill"].shardings[0],
                      src_data_rank=None)
caches = T.init_cache(cfg, B, P, "cpu")
c_d = distribute_tree(tree_map(lambda t: t.clone(), caches),
                      specs["prefill"].shardings[2], src_data_rank=None)
out = {}
tok = prompt
for kind in ("prefill", "decode"):
    make = lm.make_prefill_step if kind == "prefill" else lm.make_decode_step
    caches, want = make(cfg)(params, {"tokens": tok}, caches)
    b_d = distribute_tree({"tokens": tok}, specs[kind].shardings[1],
                          src_data_rank=None)
    del widths[:]
    c_d, got = make(cfg, ctx=ctx)(p_d, b_d, c_d)
    row = {"widths": list(widths),
           "logits": [float((full(got) - want).abs().max()),
                      float(want.abs().max())]}
    for leaf in ("S", "tm_x"):
        g, w = c_d["groups"]["b0"]["mix"][leaf], caches["groups"]["b0"]["mix"][leaf]
        row[leaf] = [float((full(g) - w).abs().max()), float(w.abs().max()),
                     [str(p) for p in g.placements]]
    out[kind] = row
    tok = lm.greedy_sample(want)[:, None]
done(out)
"""


def test_sharded_rwkv_prefill_and_decode_match_the_plain_steps(tmp_path):
    """rwkv6-1.6b at smoke size (float32, 4 heads of 16) on a (2, 2)
    gloo mesh under ``SERVE_RULES``: a 32-token prefill of 4 prompts,
    then one decode step, against the plain steps.  The time mix runs
    on each rank's two local heads (``wr`` 64 x 32 a rank); the logits,
    the state ``S`` and the last token ``tm_x`` agree within 2e-5 of the
    largest entry (float32, as ``tests/test_kernels.py``), and ``S``
    keeps the reference's spec, split over batch alone."""
    out = run_ranks(RWKV_SERVE_CHILD, 4, tmp_path)
    for kind in ("prefill", "decode"):
        row = out[kind]
        assert row["widths"] == [[64, 32]] * 2, (kind, row)  # 2 layers
        for key in ("logits", "S", "tm_x"):
            err, scale = row[key][:2]
            assert err <= 2e-5 * scale, (kind, key, row)
        assert row["S"][2] == ["S(1)", "R"], row     # (layers, batch, ...)


TIME_MIX_CHILD = r"""
import json
import torch
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo import Trace
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import rwkv as R, transformer as T
from repro_torch.sharding import (TRAIN_RULES, ShardCtx, constrain,
                                  on_whole_values, scope, tree_shardings)


cfg = reduce_for_smoke(get_config("rwkv6-1.6b"))
B, S, Dm = 8, 32, cfg.d_model
out = {}
with D.fake_group(8):
    mesh = make_dev_mesh(4, 2)
    ctx = ShardCtx(mesh, TRAIN_RULES)
    defs = R.rwkv_defs(cfg)
    ab = T.tree_abstract(defs, cfg)
    p = D.on_meta(ab, tree_shardings(ab, T.tree_logical(defs), mesh,
                                     TRAIN_RULES))
    h = D.on_meta({"h": torch.empty(B, S, Dm, dtype=torch.bfloat16,
                                    device="meta")},
                  {"h": (mesh, ctx.placements((B, S, Dm),
                                              ("batch", None, None)))})["h"]
    leaves = [h] + [p[k] for k in R._TIME_MIX]
    for t in leaves:
        t.requires_grad_(True)
    routes = {
        "whole": lambda: on_whole_values(
            lambda pm, x: R.rwkv_time_mix(cfg, pm, x, mode="train",
                                          state=None), p, h),
        "local": lambda: R.rwkv_time_mix(cfg, p, h, mode="train",
                                         state=None)}
    for name, route in routes.items():
        tr = Trace()
        tr.arguments(p, h)
        with tr, scope(ctx):
            o, _ = route()
            y = constrain(h + o, ("batch", None, None), ctx)
            torch.autograd.grad(y.float().sum(), leaves, allow_unused=True)
        out[name] = {"flops": tr.flops,
                     "gathers": [s for c, s in tr.collective_shapes
                                 if c == "all-gather"]}
# the low-rank ddlerp and the decay lora's first product, whole-D on a
# rank's batch: what every rank of "model" computes alike
x = torch.empty(B // 4, S, Dm, dtype=torch.bfloat16, device="meta",
                requires_grad=True)
pw = {k: torch.empty(p[k].shape, dtype=p[k].dtype, device="meta",
                     requires_grad=True) for k in R._WHOLE}
tr = Trace()
with tr:
    mixed = R._ddlerp(x, x, pw)
    low = torch.tanh(mixed[3] @ pw["wa"])
    torch.autograd.grad(mixed.float().sum() + low.float().sum(),
                        [x] + list(pw.values()))
out["ddlerp"] = tr.flops
print(json.dumps(out))
"""


def test_time_mix_on_local_heads_costs_a_ranks_share():
    """RWKV's time mix and its backward, traced for rank 0 of a fake
    (4, 2) group under ``TRAIN_RULES`` (rwkv6-1.6b at smoke size, 8 x 32
    tokens, 4 heads over "model"), on whole values (``on_whole_values``)
    and on the local heads: the local route's FLOPs are at most the
    whole-value route's over the 8 ranks, plus the low-rank products
    every rank of "model" repeats (so within 1/n_model of it too); and it
    all-gathers no (batch, seq)-sized activation, where the whole-value
    route gathers the input's batch over "data"."""
    res = subprocess.run([sys.executable, "-c", TIME_MIX_CHILD],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    whole, local, ddlerp = out["whole"], out["local"], out["ddlerp"]
    assert 0 < local["flops"] <= whole["flops"] / 8 + ddlerp, out
    activation = [2, 32]            # (local batch, seq)
    assert any(s[:2] == activation for s in whole["gathers"]), whole
    assert not any(s[:2] == activation for s in local["gathers"]), local


MOE_COST_CHILD = r"""
import dataclasses, json
import torch
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo import Trace
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import moe as M, transformer as T
from repro_torch.sharding import (TRAIN_RULES, ShardCtx, constrain,
                                  on_whole_values, scope, tree_shardings)

# 3 experts: d_expert splits over "model", as 60 and 8 experts on 16 do
cfg = reduce_for_smoke(get_config("qwen2-moe-a2.7b"))
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
B, S, Dm = 8, 32, cfg.d_model
out = {}
with D.fake_group(8):
    mesh = make_dev_mesh(4, 2)
    ctx = ShardCtx(mesh, TRAIN_RULES)
    defs = M.moe_defs(cfg)
    ab = T.tree_abstract(defs, cfg)
    p = D.on_meta(ab, tree_shardings(ab, T.tree_logical(defs), mesh,
                                     TRAIN_RULES))
    h = D.on_meta({"h": torch.empty(B, S, Dm, dtype=torch.bfloat16,
                                    device="meta")},
                  {"h": (mesh, ctx.placements((B, S, Dm),
                                              ("batch", None, None)))})["h"]
    leaves = [h] + [p[k] for k in sorted(p)]
    for t in leaves:
        t.requires_grad_(True)
    routes = {
        "whole": lambda: on_whole_values(
            lambda pm, x: M.moe_apply_global(cfg, pm, x), p, h),
        "local": lambda: M.moe_apply(cfg, p, h, ctx)}
    for name, route in routes.items():
        tr = Trace()
        tr.arguments(p, h)
        with tr, scope(ctx):
            o, aux = route()
            y = constrain(h + o, ("batch", None, None), ctx)
            torch.autograd.grad(y.float().sum() + aux, leaves,
                                allow_unused=True)
        out[name] = {"flops": tr.flops, "by_op": dict(tr.flops_by_op),
                     "gathers": [s for c, s in tr.collective_shapes
                                 if c == "all-gather"]}
out["router"] = 3 * 2 * (B // 4) * S * Dm * cfg.moe.n_experts
print(json.dumps(out))
"""


def test_global_moe_on_token_shards_costs_a_ranks_share():
    """The global MoE and its backward, traced for rank 0 of a fake (4,
    2) group under ``TRAIN_RULES`` (qwen2-moe-a2.7b at smoke size with 3
    experts, so that d_expert splits over "model" as the production
    MoEs' does; 8 x 32 tokens), on whole values (``on_whole_values``,
    the route before ``moe._on_token_shards``) and on the rank's tokens
    and d_expert slice: the local route's FLOPs are at most the whole
    route's over the 8 ranks, plus the router's three products on the
    rank's tokens, which every rank of "model" repeats; it all-gathers
    no (batch, seq)-sized activation, where the whole route gathers the
    input's batch over "data"; and the segmented expert products are
    counted, forward and backward."""
    res = subprocess.run([sys.executable, "-c", MOE_COST_CHILD],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    whole, local = out["whole"], out["local"]
    assert 0 < local["flops"] <= whole["flops"] / 8 + out["router"], out
    activation = [2, 32]            # (local batch, seq)
    assert any(s[:2] == activation for s in whole["gathers"]), whole
    assert not any(s[:2] == activation for s in local["gathers"]), local
    assert local["by_op"].get("repro_torch.segment_mm", 0) > 0, local
    assert local["by_op"].get("repro_torch.segment_mm_tn", 0) > 0, local


ELASTIC_SAVE = r"""
import dataclasses
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_map
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import train_specs
from repro_torch.launch.train import build_state
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import TRAIN_RULES, ShardCtx, distribute_tree, full

cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                          dtype="float32")
opt = AdamW(lr=1e-3)
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
mesh = make_dev_mesh(4, 2, device_type="cpu")
cell, _ = train_specs(cfg, ShapeCfg("t", 32, 8, "train"), mesh, opt)
state = distribute_tree(build_state(cfg, opt, 0, "cpu"), cell.shardings[0])
state, m = lm.make_train_step(cfg, opt, ctx=ShardCtx(mesh, TRAIN_RULES))(
    state, distribute_tree(batch, cell.shardings[1]))
whole = tree_map(full, state)
if RANK == 0:
    mgr = CheckpointManager(os.environ["CKPT"], device="cpu")
    mgr.save(1, whole, block=True)
    mgr.close()
done({"loss1": float(m["loss"])})
"""

ELASTIC_RESTORE = r"""
import dataclasses
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import train_specs
from repro_torch.launch.train import build_state
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.elastic import plan_resize
from repro_torch.sharding import TRAIN_RULES, ShardCtx, distribute_tree, full

cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                          dtype="float32")
opt = AdamW(lr=1e-3)
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
# "lose" two of four workers of 2 chips: replan to 4 ranks
plan = plan_resize(alive_workers=[0, 1], chips_per_worker=2,
                   model_parallel=2, global_batch=8)
mesh = make_dev_mesh(*plan.mesh_shape, device_type="cpu")
cell, _ = train_specs(cfg, ShapeCfg("t", 32, 8, "train"), mesh, opt)
mgr = CheckpointManager(os.environ["CKPT"], device="cpu")
# onto the abstract state: each rank reads the leaves, keeps its slices
step0, state = mgr.restore(cell.abstract[0], shardings=cell.shardings[0])
mgr.close()
state, m2 = lm.make_train_step(cfg, opt, ctx=ShardCtx(mesh, TRAIN_RULES))(
    state, distribute_tree(batch, cell.shardings[1]))
# the same two steps on one device
plain = lm.make_train_step(cfg, opt)
s, _ = plain(build_state(cfg, opt, 0, "cpu"), batch)
s, p2 = plain(s, batch)
done({"mesh": list(plan.mesh_shape), "restored": step0,
      "loss2": float(m2["loss"]), "plain_loss2": float(p2["loss"]),
      "step": int(full(state["step"]))})
"""


def test_elastic_restore_under_smaller_mesh(tmp_path):
    """Twin of the reference's elastic test: a step on the (4, 2) mesh,
    a checkpoint, then two workers lost, ``plan_resize`` to 4 ranks, the
    state restored onto the smaller mesh (``restore(shardings=)``) and
    a second step, whose loss is the one-device run's.  The restore
    reads into the abstract (meta) state that ``train_specs`` gives."""
    env = {"CKPT": os.path.join(str(tmp_path), "ckpt")}
    run_ranks(ELASTIC_SAVE, 8, tmp_path, env=env)
    out = run_ranks(ELASTIC_RESTORE, 4, tmp_path, env=env)
    assert out["mesh"][0] * out["mesh"][1] <= 4
    assert out["restored"] == 1 and out["step"] == 2
    assert math.isfinite(out["loss2"])
    assert abs(out["loss2"] - out["plain_loss2"]) < DLOSS, out


FAKE_CHILD = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import AbstractMesh, placements, resolve_spec, TRAIN_RULES
from torch.distributed.tensor import distribute_tensor

out = {}
for multi, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi, device_type="cpu")
    out[str(world)] = [list(m.mesh_dim_names), list(m.shape)]
    dist.destroy_process_group()
# a joint ("pod", "data") dim: shard p * n_data + d on (pod p, data d)
rows = {}
t = torch.arange(8 * 3).reshape(8, 3)
spec = resolve_spec((8, 3), ("batch", None), AbstractMesh((2, 2, 2),
                    ("pod", "data", "model")), TRAIN_RULES)
for r in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=8)
    from torch.distributed.device_mesh import init_device_mesh
    m = init_device_mesh("cpu", (2, 2, 2),
                         mesh_dim_names=("pod", "data", "model"))
    d = distribute_tensor(t, m, list(placements(spec, m)), src_data_rank=None)
    rows[r] = [m.get_coordinate(), d.to_local()[:, 0].tolist()]
    dist.destroy_process_group()
out["spec"] = [list(e) if isinstance(e, tuple) else e for e in spec]
out["rows"] = rows
print(json.dumps(out))
"""


def test_production_meshes_under_a_fake_group():
    """``make_production_mesh`` under a fake 256- and 512-rank group: the
    reference's shapes and axis names; and a joint ("pod", "data") batch
    dim puts rows p * 2 + d on (pod p, data d), as jax's spec does."""
    res = subprocess.run([sys.executable, "-c", FAKE_CHILD],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["256"] == [["data", "model"], [16, 16]]
    assert out["512"] == [["pod", "data", "model"], [2, 16, 16]]
    assert out["spec"] == [["pod", "data"], None]
    for (pod, data, _), rows in out["rows"].values():
        c = pod * 2 + data                  # two rows a shard, 3 a row
        assert rows == [6 * c, 6 * c + 3]


def test_meshes_want_a_process_group():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_dev_mesh(4, 2, device_type="cpu")
