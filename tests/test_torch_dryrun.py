"""The port's dry run (``repro_torch/launch/dryrun.py``) on the CPU,
twin of ``tests/test_distributed.py``'s dry-run test and held to the
reference's record, roofline and analytic counts.

Every cell that needs a process group runs in a subprocess under
PyTorch's fake group (the dry run's own ``fake_group``), never in the
test process: a tiny sharded cell's collectives and FLOPs; the record's
key set at every level against the keys the reference's source writes;
the memory count of the reduced qwen2-0.5b on a (4, 2) group against a
hand count; the CLI's artifact folder.  ``roofline()`` is held to the
reference's in a subprocess too (importing ``repro.launch.dryrun`` sets
``XLA_FLAGS``).  The FLOPs of one-device smoke steps, traced in the test
process on meta tensors, equal the analytic count.  The sharded decode,
whose cache write the dry run's serve cells reach, is held to the plain
decode on a (2, 2) gloo group.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_ranks import SRC, run_ranks  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import live_pairs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

REF_DRYRUN = os.path.join(SRC, "repro", "launch", "dryrun.py")


def _child(code: str, env=None, timeout: float = 300) -> dict:
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1", **(env or {})),
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


TINY = r"""
import dataclasses, json
from repro_torch.configs import get_config, reduce_for_smoke, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo import total_collective_bytes
from repro_torch.launch.mesh import make_dev_mesh

cfg = reduce_for_smoke(get_config("llama3-8b"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=8)
with D.fake_group(8):
    full, tr = D.trace_step(*D._build(cfg, shape, make_dev_mesh(4, 2),
                                      "train"))
total, per = total_collective_bytes(tr)
print(json.dumps({"collective_bytes": total, "categories": sorted(per),
                  "flops": full["flops"],
                  "arg_bytes": full["memory"]["argument_size_in_bytes"]}))
"""


def test_tiny_dryrun_traces_and_counts_collectives():
    """Twin of the reference's ``test_tiny_dryrun_compiles_and_parses_
    collectives``: a smoke train cell on a fake (4, 2) group issues
    collectives (an all-reduce or an all-gather) and costs FLOPs."""
    out = _child(TINY)
    assert out["collective_bytes"] > 0
    assert "all-reduce" in out["categories"] or \
        "all-gather" in out["categories"]
    assert out["flops"] > 0 and out["arg_bytes"] > 0


C6 = r"""
import dataclasses, json
from repro_torch.configs import get_config, reduce_for_smoke, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo import Trace
from repro_torch.launch.mesh import make_dev_mesh

# d_ff 192: neither it nor its shard over "model" (96) is d_model (64)
cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3-8b")),
                          d_ff=192)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=48, global_batch=8)
with D.fake_group(8):
    step, args = D._build(cfg, shape, make_dev_mesh(4, 2), "train")
    tr = Trace()
    tr.arguments(args)
    with tr:
        step(*args)
print(json.dumps({"log": tr.collective_shapes,
                  "heads": cfg.attention.n_heads}))
"""


def test_heads_split_block_moves_no_mlp_hidden():
    """ROADMAP C.6: a sharded train step of llama3-8b at smoke size (4
    heads, d_model 64, d_ff 192) on a fake (4, 2) group, 8 x 48 tokens,
    its heads split over "model": no collective's operand is a (batch,
    seq, d_ff) activation, at the global or local batch, whole or
    sharded d_ff.  The residual after attention is pinned to ("batch",
    None, None); the parent's unpinned block left it split on d_model,
    and the same trace read four reduce-scatters of (2, 48, 192) and
    all-to-alls of (2, 48, 96) and (4, 48, 96), the MLP's hidden."""
    out = _child(C6)
    assert out["heads"] % 2 == 0           # the heads split over "model"
    assert out["log"], out
    hidden = [c for c in out["log"] if 48 in c[1] and
              (192 in c[1] or 96 in c[1])]
    assert not hidden, hidden


C7 = r"""
import dataclasses, json
from repro_torch.configs import get_config, reduce_for_smoke, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo import Trace
from repro_torch.launch.mesh import make_dev_mesh

# d_ff 192: neither it nor its shard over "model" (96) is d_model (64)
cfg = dataclasses.replace(reduce_for_smoke(get_config("rwkv6-1.6b")),
                          d_ff=192)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=48, global_batch=16)
with D.fake_group(8):
    step, args = D._build(cfg, shape, make_dev_mesh(4, 2), "train")
    tr = Trace()
    tr.arguments(args)
    with tr:
        step(*args)
print(json.dumps({"log": tr.collective_shapes}))
"""


def test_channel_mix_gradient_stays_on_its_d_ff_shard():
    """ROADMAP C.7: a sharded train step of rwkv6-1.6b at smoke size (d
    model 64, d_ff 192) on a fake (4, 2) group, 16 x 48 tokens: no
    collective's operand is a (batch, seq, d_ff) activation, whole or
    sharded.  The channel mix pins ``v`` to ("batch", None, None); the
    parent's unpinned ``r * v`` left ``v``'s gradient split on d_model,
    and the same trace read two reduce-scatters of (8, 48, 96), the
    gradient of ``k`` over twice the rank's batch on its d_ff shard."""
    out = _child(C7)
    assert out["log"], out
    hidden = [c for c in out["log"] if 48 in c[1] and
              (192 in c[1] or 96 in c[1])]
    assert not hidden, hidden


TAIL = r"""
import dataclasses, json
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh

cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=5)
with D.fake_group(256):
    full, tr = D.trace_step(*D._build(cfg, SHAPES["train_4k"],
                                      make_production_mesh(), "train"))
print(json.dumps({"largest": tr.live_at_peak(1)[0], "flops": full["flops"],
                  "vocab": cfg.vocab}))
"""


def test_tail_blocks_keep_the_unembedding_on_local_tokens():
    """recurrentgemma-2b at full width cut to 5 layers, one (rec, rec,
    attn) group and the two-layer tail its 26 layers leave, traced for
    rank 0 of train_4k's (16, 16) mesh: no storage at the peak is as
    large as the global batch's logits over one vocab shard (256 x 4096
    x 16000 bf16).  A tail block's output is a partial sum over
    "model"; pinned only after its mixer (ROADMAP C.6) and not after
    the block, it led DTensor to move the residual's d_model over "data"
    and compute all 256 x 4096 tokens' logits on every rank (a 537 GB
    storage, 1.29e14 FLOPs where the pinned tail reads 4.49e13)."""
    out = _child(TAIL)
    shard_logits = 256 * 4096 * (out["vocab"] // 16) * 2
    assert out["largest"]["bytes"] < shard_logits, out
    assert out["flops"] < 6e13, out


def _fn(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _reference_keys() -> dict:
    """The keys the reference's dry run writes, read from its source:
    ``run_cell``'s record (its literal and every ``rec[...] =``),
    ``_compile_cell``'s ``full`` (``dryrun.py:90-98``), ``_mem_dict``
    (``:47-51``), ``_extrapolate``'s cost keys (``:113``) and
    ``roofline`` (``:132``, ``:144-150``)."""
    tree = ast.parse(open(REF_DRYRUN).read())
    run = _fn(tree, "run_cell")
    rec = set()
    for n in ast.walk(run):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) and \
                n.targets[0].id == "rec":
            rec |= _dict_keys(n.value)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                    ast.Subscript):
            rec.add(n.targets[0].slice.value)
    full = _dict_keys(next(n.value for n in ast.walk(_fn(tree, "_compile_cell"))
                           if isinstance(n, ast.Return)))
    mem = {e.value for n in ast.walk(_fn(tree, "_mem_dict"))
           if isinstance(n, ast.Tuple) for e in n.elts}
    cost = {e.value for n in ast.walk(_fn(tree, "_extrapolate"))
            if isinstance(n, ast.For) for e in n.iter.elts}
    roof = set()
    for n in ast.walk(_fn(tree, "roofline")):
        if isinstance(n, ast.Dict):
            roof |= _dict_keys(n)
    return {"rec": rec, "full": full, "memory": mem, "cost": cost,
            "roofline": roof}


RECORDS = r"""
import json
from repro_torch.launch import dryrun as D

out = {"ok": D.run_cell("qwen2-0.5b", "decode_32k", "single"),
       "multi": D.run_cell("qwen2-0.5b", "decode_32k", "multi", do_cost=False),
       "skipped": D.run_cell("qwen2-0.5b", "long_500k", "single")}

def boom(*a, **k):
    raise RuntimeError("planted")
D._compile_cell = boom
out["failed"] = D.run_cell("qwen2-0.5b", "decode_32k", "single")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    return _child(RECORDS)


def test_record_keys_are_the_references(records):
    """An ok cell has the reference's record keys at every level (the
    decode cell of full-width qwen2-0.5b on the 256-rank fake group); a
    multi-pod cell without cost, a skipped and a failed cell the
    reference's subsets."""
    ref = _reference_keys()
    ok = records["ok"]
    assert ok["status"] == "ok", ok.get("traceback")
    base = {"arch", "shape", "mesh", "kind", "overrides", "tokens",
            "status"}
    assert set(ok) == ref["rec"] - {"reason", "error", "traceback"}
    assert set(ok) == base | {"full", "cost_extrapolated", "cost_points",
                              "modeled_bytes", "roofline"}
    assert set(ok["full"]) == ref["full"]
    assert set(ok["full"]["memory"]) == ref["memory"]
    assert set(ok["cost_extrapolated"]) == ref["cost"]
    assert ok["cost_points"] == [ok["full"]]
    assert set(ok["roofline"]) == ref["roofline"]
    assert set(records["multi"]) == base | {"full"}
    assert set(records["skipped"]) == base | {"reason"} and \
        records["skipped"]["status"] == "skipped"
    assert set(records["failed"]) == base | {"error", "traceback"}
    assert records["failed"]["error"] == "RuntimeError: planted"


def test_decode_cell_counts(records):
    """The decode cell on the production mesh: one new token of 128
    rows against a 32k cache; the KV cache is donated (alias = the
    caches' bytes) and the step's collectives and FLOPs are nonzero."""
    ok = records["ok"]
    mem = ok["full"]["memory"]
    cfg = get_config("qwen2-0.5b")
    a = cfg.attention
    # the cache (k, v) at the serve rules: batch over data (16), the
    # positions over model (16); "len" int32 over data
    cache = 2 * cfg.n_layers * (128 // 16) * (32768 // 16) * a.n_kv_heads * \
        a.d_head * 2 + cfg.n_layers * (128 // 16) * 4
    assert mem["alias_size_in_bytes"] == cache
    assert mem["output_size_in_bytes"] > mem["alias_size_in_bytes"]
    assert ok["tokens"] == 128 and ok["full"]["flops"] > 0
    assert ok["full"]["collective_bytes_per_device"] > 0
    assert ok["full"]["compile_s"] >= 0 and ok["full"]["hlo_chars"] > 0


ROOF = r"""
import json
import repro.launch.dryrun as R
from repro.configs import get_config as ref_config
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D

R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW = D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW
out = {}
for kind, cost in (("train", (1.2e14, 3e12, 8.9e9)),
                   ("decode", (3.1e11, 0.0, 0.0)),
                   ("prefill", (2.5e13, 1e12, 4e9))):
    fl, by, co = cost
    rec = {"kind": kind, "tokens": 1048576 if kind != "decode" else 128,
           "cost_extrapolated": {"flops": fl, "bytes_accessed": by,
                                 "collective_bytes_per_device": co},
           "modeled_bytes": {"total": 5.2e10}}
    for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b"):
        out[f"{kind}/{arch}"] = [R.roofline(rec, 256, ref_config(arch)),
                                 D.roofline(rec, 256, get_config(arch))]
print(json.dumps(out))
"""


def test_roofline_equals_the_references_at_h100_constants():
    """``roofline()`` of the port equals the reference's on the same
    records, exactly, once the reference's three constants are the
    port's (a zero collective and a zero FLOP count included)."""
    out = _child(ROOF, {"JAX_PLATFORMS": "cpu"})
    for ref, port in out.values():
        assert port == ref
    assert D.PEAK_FLOPS == 989e12 and D.HBM_BW == 3.35e12 and \
        D.LINK_BW == 50e9


def _smoke(L=2):
    return dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                               n_layers=L, remat="block")


def _meta_step(cfg, kind, B, S):
    """A one-device step of ``kind`` on meta tensors: (step, args)."""
    params = T.tree_abstract(T.param_defs(cfg), cfg)
    tok = lambda: torch.empty((B, S), dtype=torch.int32, device="meta")
    if kind == "train":
        opt = AdamW(lr=1e-3)
        state = {"params": params, "opt": opt.init_abstract(params),
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
        return lm.make_train_step(cfg, opt), (state, {"tokens": tok(),
                                                      "labels": tok()})
    caches = T.tree_abstract(T.cache_defs(cfg, B, S), cfg)
    return lm.make_prefill_step(cfg), (params, {"tokens": tok()}, caches)


def _analytic(cfg, kind, B, S) -> int:
    """Matmul FLOPs, 2 N a token a pass, plus the flash forward's live
    pairs (4 B H dh a pair) and its backward's five full-block products
    (10 B H S^2 dh): the only ops of these steps that FlopCounterMode's
    formulas count."""
    a, D_, F = cfg.attention, cfg.d_model, cfg.d_ff
    n_blk = (D_ * (a.n_heads + 2 * a.n_kv_heads) * a.d_head
             + a.n_heads * a.d_head * D_ + 3 * D_ * F) * cfg.n_layers
    head = cfg.vocab * D_
    t = B * S
    attn_f = 4 * B * a.n_heads * a.d_head * live_pairs(S, True, a.window) * \
        cfg.n_layers
    if kind == "prefill":     # the unembed of the last token only
        return 2 * n_blk * t + 2 * head * B + attn_f
    attn_b = 10 * B * a.n_heads * S * S * a.d_head * cfg.n_layers
    # the remat unit's recompute stops once it has rebuilt what the
    # backward saved (checkpoint's early stop): a layer's down
    # projection, whose output nothing saves, does not run again
    remat = n_blk - D_ * F * cfg.n_layers
    # forward, recompute, the backward (twice a pass)
    return 2 * (n_blk + head) * t + 2 * remat * t + 4 * (n_blk + head) * t \
        + 2 * attn_f + attn_b


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_smoke_step_flops_are_the_analytic_count(kind):
    """On one device, the trace's FLOPs equal 2 N tokens a pass over the
    matmul parameters (the tied head counted as a matmul), plus the
    flash kernel's live-pair count and its backward's full-block
    products, and equal FlopCounterMode's total on the same step."""
    cfg, B, S = _smoke(), 2, 96
    full, tr = D.trace_step(*_meta_step(cfg, kind, B, S))
    assert full["flops"] == _analytic(cfg, kind, B, S)
    assert set(tr.flops_by_op) == {"aten.bmm", "aten.mm",
                                   "repro_torch.flash_attention"}
    with FlopCounterMode(display=False) as fc:
        step, args = _meta_step(cfg, kind, B, S)
        step(*args)
    assert fc.get_total_flops() == full["flops"]
    assert full["collectives"] == {} and \
        full["collective_bytes_per_device"] == 0


HAND = r"""
import dataclasses, json
from repro_torch.configs import get_config, reduce_for_smoke, SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_dev_mesh

cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                          remat="block", attn_chunk=128)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=512, global_batch=8)
out = {}
with D.fake_group(8):
    mesh = make_dev_mesh(4, 2)
    for L in (2, 4):
        full, tr = D.trace_step(*D._build(
            dataclasses.replace(cfg, n_layers=L), shape, mesh, "train"))
        out[L] = {"memory": full["memory"], "live": tr.live_at_peak(64)}
print(json.dumps(out))
"""


def test_memory_of_the_reduced_cell_is_its_hand_count():
    """Reduced qwen2-0.5b at S = 512 (q-chunks of 128) on a fake (4, 2)
    group, remat per block, 2 and 4 layers: temp grows by two layers'
    saved block inputs (each rank's (2, 512, 64) bf16 residual) and
    nothing else; the largest storage live at the peak is one
    (q-chunk, S) float32 block of the flash backward on the rank's
    (2 rows, 1 KV head, 2 q heads a group), and no (S, S) block is ever
    live there."""
    out = _child(HAND)
    two, four = out["2"], out["4"]
    saved = 2 * 512 * 64 * 2
    assert four["memory"]["temp_size_in_bytes"] - \
        two["memory"]["temp_size_in_bytes"] == 2 * saved
    for cell in (two, four):
        top = cell["live"][0]
        assert top["bytes"] == 2 * 1 * 2 * 128 * 512 * 4
        assert top["shape"][-2:] in ([128, 512], [256, 512])
        assert not any(r["shape"][-2:] == [512, 512] for r in cell["live"])
    # the arguments grow by two layers' local shards of the params (bf16)
    # and AdamW's m and v (float32): d_model over data (4), heads,
    # kv_heads and d_ff over model (2), the norms whole
    layer = (64 * 4 * 16 // 8 + 2 * 64 * 2 * 16 // 8 + 4 * 16 * 64 // 8
             + 4 * 16 // 2 + 2 * 2 * 16 // 2 + 3 * 64 * 128 // 8 + 2 * 64)
    assert four["memory"]["argument_size_in_bytes"] - \
        two["memory"]["argument_size_in_bytes"] == 2 * layer * (2 + 4 + 4)


CLI = r"""
import json, os, sys
from repro_torch.launch import dryrun as D
D.ART_DIR = sys.argv[1]
D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single",
        "--tag", "t"])
D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single",
        "--tag", "t"])
path = os.path.join(sys.argv[1], "single", "qwen2-0.5b__decode_32k__t.json")
print(json.dumps(json.load(open(path))))
"""


def test_cli_writes_its_record_into_its_own_folder(tmp_path):
    """``main`` starts its own fake group, writes ``<mesh>/<arch>__
    <shape>[__tag].json`` under its folder, ``experiments/dryrun_torch``
    by default, and skips a cached cell; the reference's
    ``experiments/dryrun`` is not the port's."""
    res = subprocess.run(
        [sys.executable, "-c", CLI, str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    assert "[ok] single qwen2-0.5b decode_32k" in res.stdout
    assert "[skip cached] single qwen2-0.5b decode_32k" in res.stdout
    assert os.path.normpath(D.ART_DIR).endswith(
        os.path.join("experiments", "dryrun_torch"))


DECODE = r"""
import dataclasses
import numpy as np
from repro_torch.configs import ShapeCfg, get_config, reduce_for_smoke
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.specs import serve_specs
from repro_torch.models import lm, transformer as T
from repro_torch.sharding import SERVE_RULES, ShardCtx, distribute_tree, full

cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                          dtype="float32")
B, P, S = 4, 31, 64
params = T.tree_init(T.param_defs(cfg), cfg, 0, "cpu")
rng = np.random.default_rng(0)
prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P)).astype(np.int32))
caches = T.init_cache(cfg, B, S, "cpu")
caches, logits = lm.make_prefill_step(cfg)(params, {"tokens": prompt}, caches)
mesh = make_dev_mesh(2, 2, device_type="cpu")
cell = serve_specs(cfg, ShapeCfg("d", S, B, "decode"), mesh, "decode")
p_d = distribute_tree(params, cell.shardings[0], src_data_rank=None)
# a copy of its own: a rank's shard may be a view of the tensor it holds
c_d = distribute_tree(tree_map(lambda t: t.clone(), caches),
                      cell.shardings[2], src_data_rank=None)
plain = lm.make_decode_step(cfg)
shard = lm.make_decode_step(cfg, ctx=ShardCtx(mesh, SERVE_RULES))
tok = lm.greedy_sample(logits)[:, None]
errs, cache_errs = [], []
for _ in range(2):      # rows 31 and 32: either side of the model split
    caches, want = plain(params, {"tokens": tok}, caches)
    b_d = distribute_tree({"tokens": tok}, cell.shardings[1],
                          src_data_rank=None)
    c_d, got = shard(p_d, b_d, c_d)
    errs.append(float((full(got) - want).abs().max()))
    cache_errs.append(max(float((full(g) - w).abs().max()) for g, w in
                          zip(tree_leaves(c_d), tree_leaves(caches))))
    tok = lm.greedy_sample(want)[:, None]
done({"errs": errs, "cache_errs": cache_errs,
      "k_dims": [getattr(p, "dim", None)
                 for p in c_d["groups"]["b0"]["attn"]["k"].placements]})
"""


def test_sharded_decode_matches_the_plain_decode(tmp_path):
    """Two decode steps of the reduced qwen2-0.5b (float32) on a (2, 2)
    gloo group, each rank writing its shard of a cache split over batch
    and positions: the plain decode's logits and caches, the new rows
    at positions 31 and 32 on either side of the positions' split."""
    out = run_ranks("import torch\n" + DECODE, 4, tmp_path)
    assert out["k_dims"] == [1, 2]        # (layers, batch, positions, ...)
    # float32; the sharded projections sum in another order
    assert max(out["errs"]) < 1e-5, out
    assert max(out["cache_errs"]) < 1e-5, out


def test_e2e_step_reads_the_ports_artifacts(tmp_path, monkeypatch):
    """The ``e2e_step`` twin's roofline rows come from the port's
    folder: one row a cell whose record has a roofline."""
    from repro_torch.benchmarks import e2e_step
    single = tmp_path / "single"
    single.mkdir()
    roof = {"compute_s": 0.12, "memory_s": 0.02, "collective_s": 0.18,
            "dominant": "collective_s", "roofline_fraction": 0.07}
    (single / "qwen2-0.5b__train_4k.json").write_text(json.dumps(
        {"arch": "qwen2-0.5b", "shape": "train_4k", "status": "ok",
         "roofline": roof}))
    (single / "rwkv6-1.6b__long_500k.json").write_text(json.dumps(
        {"arch": "rwkv6-1.6b", "shape": "long_500k", "status": "failed"}))
    monkeypatch.setattr(e2e_step, "ART_DIR", str(tmp_path))
    rows = e2e_step.run(quick=True, device="cpu")
    assert [r["name"] for r in rows] == ["e2e_train_step_qwen2-0.5b",
                                         "roofline_qwen2-0.5b_train_4k"]
    assert rows[1]["roofline"] == roof


LOOKUP = r"""
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models.lm import _lookup
from repro_torch.sharding import distribute_tree, full, placements

mesh = make_dev_mesh(2, 2, device_type="cpu")
torch.manual_seed(0)
V, D = 64, 8
emb = torch.randn(V, D, dtype=torch.float64)
out = {}
for label, (B, S) in (("vocab_parallel", (4, 3)), ("gathered", (4, 40))):
    tok = torch.randint(0, V, (B, S))
    g = torch.randn(B, S, D, dtype=torch.float64)
    e = emb.clone().requires_grad_()
    want = e[tok]
    want_grad, = torch.autograd.grad(want, e, g)
    e_d = distribute_tree({"e": emb}, {"e": (mesh, placements(("model", "data"), mesh))},
                          src_data_rank=None)["e"].requires_grad_()
    t_d, g_d = (distribute_tree({"t": t}, {"t": (mesh, placements(spec, mesh))},
                                src_data_rank=None)["t"]
                for t, spec in ((tok, ("data", None)), (g, ("data", None, None))))
    got = _lookup(e_d, t_d)
    got_grad, = torch.autograd.grad(got, e_d, g_d)
    out[label] = [float((full(got) - want).abs().max()),
                  float((full(got_grad) - want_grad).abs().max()),
                  [str(p) for p in got.placements]]
done(out)
"""


def test_sharded_embedding_lookup_matches_the_plain_one(tmp_path):
    """``lm._lookup`` on a (2, 2) gloo group, the table split as the
    train rules split it (vocab over model, d_model over data): with
    fewer local tokens than vocab rows each rank looks up its own rows
    (a partial sum over "model"), with more it gathers the table; both
    give the plain lookup and its gradient."""
    out = run_ranks("import torch\n" + LOOKUP, 4, tmp_path)
    for label in ("vocab_parallel", "gathered"):
        err, grad_err, _ = out[label]
        assert err < 1e-12 and grad_err < 1e-12, out
