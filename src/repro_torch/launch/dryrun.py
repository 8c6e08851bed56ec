"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta
tensors under a fake process group, and count what one rank does.

Twin of ``repro/launch/dryrun.py``, which lowers and compiles each cell
for 512 placeholder devices that it forces at import.  Here nothing
happens at import: ``main`` (and ``fake_group``, which ``run_cell``
enters) starts PyTorch's fake process group, 256 ranks for ``single``
and 512 for ``multi``, this process rank 0.  Its collectives do nothing
and talk to no one.  Per cell:

  1. the production mesh (``launch/mesh.py``) over that group, the
     step's arguments as DTensors whose local shards are meta tensors
     (``train_specs``/``serve_specs``' abstract trees and shardings),
     and the port's own step (``lm.make_train_step``,
     ``make_prefill_step``, ``make_decode_step``) under ``ShardCtx``
     with ``TRAIN_RULES`` or ``SERVE_RULES``, run once under
     ``hlo.Trace``: nothing touches a card, and the flash and rg_lru
     kernels take their traced route (the kernel's one output, the
     backward the card runs);
  2. the record, with the reference's keys at every level.  Eager
     PyTorch has no scan, so the trace counts every layer: ``cost_points``
     is ``[full]`` and ``cost_extrapolated`` its count;
  3. a JSON artifact in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>
     .json``, the port's own folder (the reference's ``experiments/dryrun``
     is never written).

What the ``full`` keys hold in the port: ``compile_s`` the trace's
seconds; ``flops``, ``bytes_accessed``, ``collective_bytes_per_device``
and ``collectives`` ``hlo.Trace``'s counts of rank 0; ``hlo_chars`` the
characters of the trace's op listing (``launch/hlo.py``).  ``memory``:

- ``argument_size_in_bytes``: the rank's local shards of the step's
  inputs;
- ``output_size_in_bytes``: the distinct storages of its outputs;
- ``alias_size_in_bytes``: the outputs that stand for a donated
  argument: the new train state (the train step donates its state, as
  the reference's ``donate_argnums=0``) and the caches (updated in
  place by prefill and decode, which donate them);
- ``temp_size_in_bytes``: the peak of the live bytes the step allocates
  (``hlo.Trace.peak``, by storage lifetime), less its outputs that no
  argument donates (metrics, logits).  So ``argument + output - alias +
  temp`` is the step's peak, as in XLA's accounting, and ``argument +
  temp`` is what a card holds at the peak bar those outputs.  Eager
  PyTorch writes the new state beside the donated one, not into it, so
  the train step's temp holds the new state where it is live at the
  peak;
- ``generated_code_size_in_bytes``: 0 (eager runs prebuilt kernels).

The roofline takes the H100's constants in place of v5e's, a port
choice that is recorded and not held to the reference (ROADMAP A.8):
``PEAK_FLOPS`` the dense bf16 tensor-core peak of the H100 SXM,
``HBM_BW`` its HBM3 rate, and ``LINK_BW`` 50e9 B/s, one 400 Gb/s NIC a
GPU (an 8-GPU HGX H100 node has one ConnectX-7 a GPU).  The link term
takes the NIC and not NVLink 4 (450 GB/s a direction within a node)
because the (16, 16) mesh is 32 nodes of 8: each "data" group of 16
ranks spans 16 nodes and each "model" group spans 2, so every
collective's ring crosses NICs, and its slowest link sets its time.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.interop import tree_flatten, tree_unflatten
from repro_torch.launch.hlo import (Trace, cost_analysis_dict, storage_bytes,
                                    total_collective_bytes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import serve_specs, train_specs
from repro_torch.launch.traffic import modeled_bytes
from repro_torch.models import lm
from repro_torch.optim.adamw import for_arch
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES, ShardCtx,
                                  sharding_leaves)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# H100 SXM roofline constants (module note)
PEAK_FLOPS = 989e12        # dense bf16 / GPU
HBM_BW = 3.35e12           # bytes/s / GPU
LINK_BW = 50e9             # bytes/s / GPU: one 400 Gb/s NIC


@contextlib.contextmanager
def fake_group(world: int):
    """PyTorch's fake process group of ``world`` ranks, this process
    rank 0, for the span of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, mesh, placements) -> tuple:
    """The local shard's shape of a tensor of ``shape`` at
    ``placements`` (every sharded dim divides evenly:
    ``sharding.resolve_spec`` shards no other)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(j)
    return tuple(out)


def on_meta(abstract, shardings):
    """Each leaf of a meta tree as a DTensor at its ``(mesh,
    placements)`` whose local shard is a meta tensor."""
    from torch.distributed.tensor import DTensor
    leaves, tdef = tree_flatten(abstract)
    sh = sharding_leaves(shardings, tdef, len(leaves))
    return tree_unflatten(tdef, [
        DTensor.from_local(torch.empty(_local_shape(t.shape, m, pl),
                                       dtype=t.dtype, device="meta"),
                           m, list(pl), run_check=False, shape=t.shape,
                           stride=t.stride())
        for t, (m, pl) in zip(leaves, sh)])


def _build(cfg, shape, mesh, kind):
    """(step, args): the step donates its first argument (train) or its
    last (prefill, decode), whose stand-in is its first output."""
    if kind == "train":
        ctx = ShardCtx(mesh, TRAIN_RULES)
        cell, opt = train_specs(cfg, shape, mesh, for_arch(cfg.arch_id))
        step = lm.make_train_step(cfg, opt, ctx=ctx)
    elif kind in ("prefill", "decode"):
        ctx = ShardCtx(mesh, SERVE_RULES)
        cell = serve_specs(cfg, shape, mesh, kind)
        make = lm.make_prefill_step if kind == "prefill" else \
            lm.make_decode_step
        step = make(cfg, ctx=ctx)
    else:
        raise ValueError(kind)
    return step, tuple(on_meta(ab, sh) for ab, sh in zip(cell.abstract,
                                                         cell.shardings))


def trace_step(step, args):
    """Run ``step(*args)`` once under ``hlo.Trace``: (the reference's
    ``full`` dict, the trace).  The step's first output stands for its
    donated argument (the train state, the caches; module note)."""
    tr = Trace()
    tr.arguments(args)
    t0 = time.time()
    with tr:
        out = step(*args)
    dt = time.time() - t0
    output = sum(storage_bytes(out).values())
    alias = sum(storage_bytes(out[0]).values())
    del out
    cost = cost_analysis_dict(tr)
    coll_total, coll_per = total_collective_bytes(tr)
    return {
        "compile_s": round(dt, 1),
        "memory": {"argument_size_in_bytes": tr.argument,
                   "output_size_in_bytes": output,
                   "temp_size_in_bytes": max(0, tr.peak - (output - alias)),
                   "alias_size_in_bytes": alias,
                   "generated_code_size_in_bytes": 0},
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes accessed"],
        "collective_bytes_per_device": coll_total,
        "collectives": coll_per,
        "hlo_chars": tr.chars,
    }, tr


def _compile_cell(cfg, shape, mesh, kind):
    return trace_step(*_build(cfg, shape, mesh, kind))[0]


def roofline(record: dict, n_chips: int, cfg) -> dict:
    # the trace counts rank 0's own ops, i.e. PER-DEVICE numbers, so each
    # term divides by one GPU's peak.  The memory term uses the
    # fusion-aware modeled traffic (launch/traffic.py); the unfused
    # "bytes accessed" (also recorded) counts every elementwise op's
    # reads and writes.
    fl = record["cost_extrapolated"]["flops"]
    by = record["modeled_bytes"]["total"]
    co = record["cost_extrapolated"]["collective_bytes_per_device"]
    t_c = fl / PEAK_FLOPS
    t_m = by / HBM_BW
    t_l = co / LINK_BW
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_l}
    dom = max(terms, key=terms.get)
    # 6ND for train (fwd+bwd), 2ND for inference passes; attention FLOPs
    # are excluded from MODEL_FLOPS, so the useful ratio surfaces
    # attention, remat and replicated work together
    factor = 6 if record["kind"] == "train" else 2
    model_flops = factor * cfg.n_active_params * record["tokens"]
    # the time the useful FLOPs would take at peak over the dominant
    # term's; 1.0 = compute bound with zero waste
    ideal = model_flops / (n_chips * PEAK_FLOPS)
    worst = max(terms.values())
    return {
        **terms,
        "dominant": dom,
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / (fl * n_chips)) if fl else 0.0,
        "roofline_fraction": (ideal / worst) if worst > 0 else 0.0,
    }


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    changes = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        changes[k] = v
    return dataclasses.replace(cfg, **changes)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             do_cost: bool = True, overrides=None) -> dict:
    """One cell's record, under a fake group of its own."""
    cfg = _apply_overrides(get_config(arch), overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind, "overrides": list(overrides or []),
           "tokens": shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    multi = mesh_kind == "multi"
    n_chips = 512 if multi else 256
    try:
        with fake_group(n_chips):
            mesh = make_production_mesh(multi_pod=multi)
            rec["full"] = _compile_cell(cfg, shape, mesh, shape.kind)
            if do_cost and not multi:
                full = rec["full"]
                rec["cost_extrapolated"] = {
                    k: full[k] for k in ("flops", "bytes_accessed",
                                         "collective_bytes_per_device")}
                rec["cost_points"] = [full]
                rec["modeled_bytes"] = modeled_bytes(
                    cfg, shape, mesh,
                    TRAIN_RULES if shape.kind == "train" else SERVE_RULES,
                    shape.kind)
                rec["roofline"] = roofline(rec, n_chips, cfg)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="ModelConfig overrides (e.g. --set kv_dtype=int8)")
    ap.add_argument("--tag", default="",
                    help="artifact suffix so variants don't clobber baselines")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    for mk in meshes:
        outdir = os.path.abspath(os.path.join(ART_DIR, mk))
        os.makedirs(outdir, exist_ok=True)
        for a, s in cells:
            suffix = f"__{args.tag}" if args.tag else ""
            path = os.path.join(outdir, f"{a}__{s}{suffix}.json")
            if os.path.exists(path) and not args.force:
                print(f"[skip cached] {mk} {a} {s}", flush=True)
                continue
            t0 = time.time()
            rec = run_cell(a, s, mk, do_cost=not args.no_cost,
                           overrides=args.overrides)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = ""
            if status == "ok":
                mem = rec["full"]["memory"]
                gb = (mem["argument_size_in_bytes"]
                      + mem["temp_size_in_bytes"]) / 1e9
                extra = f"mem/dev={gb:.2f}GB"
                if "roofline" in rec:
                    r = rec["roofline"]
                    extra += (f" dom={r['dominant']}"
                              f" t=({r['compute_s']:.4f},"
                              f"{r['memory_s']:.4f},{r['collective_s']:.4f})s")
            elif status == "failed":
                extra = rec["error"][:200]
            else:
                extra = rec["reason"][:80]
            print(f"[{status}] {mk} {a} {s} ({time.time()-t0:.0f}s) {extra}",
                  flush=True)


if __name__ == "__main__":
    main()
