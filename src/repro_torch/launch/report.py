"""Generate the port's EXPERIMENTS.md from its dry-run artifacts + perf log.

Twin of ``repro/launch/report.py``: the same tables, row for row and
character for character, over the port's records; the prose is the
port's (H100 constants, a trace on meta tensors in place of a compile).

    PYTHONPATH=src python -m repro_torch.launch.report

Inputs:
  experiments/dryrun_torch/{single,multi}/*.json   (launch/dryrun.py artifacts)
  experiments/dryrun_torch/perf_log.json           (perf iterations, the
                                                    reference's format)
Output: experiments/dryrun_torch/EXPERIMENTS.md (``OUT``).
"""
from __future__ import annotations

import json
import os
from glob import glob

from repro_torch.launch import dryrun as D

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
ART = os.path.join(ROOT, "experiments", "dryrun_torch")
PERF = os.path.join(ART, "perf_log.json")
OUT = os.path.join(ART, "EXPERIMENTS.md")

ARCH_ORDER = ["qwen2-0.5b", "glm4-9b", "llama3-8b", "qwen2.5-14b",
              "rwkv6-1.6b", "qwen2-moe-a2.7b", "grok-1-314b",
              "recurrentgemma-2b", "qwen2-vl-7b", "musicgen-large"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str):
    out = {}
    for p in glob(os.path.join(ART, mesh, "*.json")):
        if os.path.basename(p).count("__") > 1:
            continue  # tagged variants live in §Perf, not here
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"])] = r
    return out


def fmt_bytes(b: float) -> str:
    return f"{b/1e9:.2f}"


def eng(x: float) -> str:
    """``x`` with a power of ten that is a multiple of 3: 989e12, 50e9."""
    e = 0
    while abs(x) >= 1e3 * 10 ** e:
        e += 3
    return f"{x / 10 ** e:g}e{e}"


def dryrun_table(cells, mesh: str) -> str:
    rows = ["| arch | shape | status | compile s | mem/dev GB | "
            "collectives (count) |",
            "|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = cells.get((a, s))
            if r is None:
                continue
            if r["status"] == "skipped":
                rows.append(f"| {a} | {s} | SKIP | — | — | "
                            f"{r['reason'][:60]}… |")
                continue
            if r["status"] != "ok":
                rows.append(f"| {a} | {s} | **FAIL** | — | — | "
                            f"{r.get('error','')[:60]} |")
                continue
            m = r["full"]["memory"]
            gb = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 1e9
            coll = ", ".join(f"{k}:{int(v['count'])}" for k, v in
                             sorted(r["full"]["collectives"].items()))
            rows.append(f"| {a} | {s} | ok | {r['full']['compile_s']} | "
                        f"{gb:.1f} | {coll} |")
    return "\n".join(rows)


def roofline_table(cells) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL_FLOPS | useful/HLO | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = cells.get((a, s))
            if r is None or r.get("status") != "ok" or "roofline" not in r:
                continue
            ro = r["roofline"]
            rows.append(
                f"| {a} | {s} | {ro['compute_s']:.4f} | {ro['memory_s']:.4f}"
                f" | {ro['collective_s']:.4f} | {ro['dominant'].replace('_s','')}"
                f" | {ro['model_flops']:.2e} | {ro['useful_flops_ratio']:.2f}"
                f" | **{ro['roofline_fraction']:.3f}** |")
    return "\n".join(rows)


def perf_section() -> str:
    if not os.path.exists(PERF):
        return "_perf log not yet recorded_"
    with open(PERF) as f:
        log = json.load(f)
    out = []
    for entry in log:
        out.append(f"### {entry['cell']} — {entry['title']}\n")
        if entry.get("why"):
            out.append(entry["why"] + "\n")
        out.append("| iter | hypothesis | change | before (dom term) | "
                   "after | verdict |")
        out.append("|---|---|---|---|---|---|")
        for i, it in enumerate(entry["iterations"]):
            out.append(f"| {i+1} | {it['hypothesis']} | {it['change']} | "
                       f"{it['before']} | {it['after']} | {it['verdict']} |")
        if entry.get("summary"):
            out.append("\n" + entry["summary"])
        out.append("")
    return "\n".join(out)


def main() -> None:
    single = load("single")
    multi = load("multi")
    n_ok_s = sum(1 for r in single.values() if r["status"] == "ok")
    n_skip_s = sum(1 for r in single.values() if r["status"] == "skipped")
    n_ok_m = sum(1 for r in multi.values() if r["status"] == "ok")
    n_skip_m = sum(1 for r in multi.values() if r["status"] == "skipped")
    peak, hbm, link = eng(D.PEAK_FLOPS), eng(D.HBM_BW), eng(D.LINK_BW)

    doc = f"""# EXPERIMENTS (PyTorch/CUDA port)

Generated by `python -m repro_torch.launch.report` from
`experiments/dryrun_torch/*/*.json` (produced by `repro_torch.launch.dryrun`)
and `experiments/dryrun_torch/perf_log.json`.  Hardware constants (one
H100 SXM GPU, spec sheet, `repro_torch.launch.dryrun`): {peak} FLOP/s
dense bf16/GPU (`PEAK_FLOPS`), {hbm} B/s HBM3 (`HBM_BW`), {link} B/s/GPU
link, one 400 Gb/s NIC (`LINK_BW`).

## §Dry-run

Every (architecture x input-shape) cell is traced once, on meta tensors:
the port's own step runs as rank 0 of PyTorch's fake process group, its
arguments DTensors whose local shards are meta tensors, so no tensor
holds data and no card is touched.  Single-pod `(16,16)=("data","model")`
is a fake group of 256 ranks, multi-pod `(2,16,16)=("pod","data","model")`
one of 512.  `long_500k` runs for the sub-quadratic archs (rwkv6,
recurrentgemma) and is a REQUIRED SKIP for the 8 pure full-attention
archs (DESIGN.md §7).

Methodology notes (`repro_torch.launch.hlo`):
* Eager PyTorch has no scan: the trace runs every layer, so
  `cost_points` is `[full]` and `cost_extrapolated` is the full trace's
  count, not an extrapolation.
* Every count is rank 0's own (per-device): FLOPs by
  `torch.utils.flop_counter`'s formulas (the flash and rg_lru kernels
  register theirs through their `torch.library` ops); bytes accessed is
  every op's input and output bytes, unfused.
* Collective bytes = operand bytes of the c10d collectives the rank
  issues, by category (all-gather/all-reduce/reduce-scatter/all-to-all/
  collective-permute).
* Memory by storage lifetime: argument = the rank's local shards of the
  step's inputs; temp = the peak of the live bytes the step allocates,
  less its outputs that no argument donates.
* The `compile s` column is the trace's seconds on the host: the port
  compiles nothing.
* The roofline memory term uses the fusion-aware modeled traffic
  (`launch/traffic.py`); the traced `bytes accessed` (recorded in the
  artifacts) counts every eager op's reads and writes.

### Single-pod (16,16): {n_ok_s} ok / {n_skip_s} required-skip

{dryrun_table(single, "single")}

### Multi-pod (2,16,16): {n_ok_m} ok / {n_skip_m} required-skip

{dryrun_table(multi, "multi")}

## §Roofline (single-pod, per device)

terms: compute = traced FLOPs/GPU / {peak}; memory = modeled_HBM_bytes /
{hbm}; collective = collective_bytes/GPU / {link}.  MODEL_FLOPS = 6·N·D
(train) or 2·N·D (inference) with N = active params.  roofline frac =
(MODEL_FLOPS time at peak) / dominant term — 1.0 means compute-bound with
zero waste.  Each term is a model over the trace's counts and the spec
constants above, not a time measured on a card.

{roofline_table(single)}

## §Perf — iteration log

Entries of `experiments/dryrun_torch/perf_log.json`, in the reference's
format: each iteration is hypothesis -> change -> measure -> verdict
against the cell's dry-run baseline above.

{perf_section()}

## §Benchmarks

`PYTHONPATH=src python -m repro_torch.benchmarks.run` emits one CSV block
per paper figure/table, rows named as the reference's (`--device cuda`
on the card; `--quick --device cpu` for a plain run on the host).
"""
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(doc)
    print(f"wrote {OUT} ({n_ok_s}+{n_skip_s} single, "
          f"{n_ok_m}+{n_skip_m} multi cells)")


if __name__ == "__main__":
    main()
