"""Recompute roofline/modeled-bytes fields in existing dry-run artifacts.

Twin of ``repro/launch/recompute.py``.  Reuses the stored (expensive)
trace outputs — cost_extrapolated, collectives, memory — and re-derives
the cheap analysis fields after a formula change, without tracing
again.  It makes no tensor and starts no process group: the mesh is a
``sharding.AbstractMesh`` of the production shape.  Run after editing
dryrun.roofline or traffic.modeled_bytes:

    PYTHONPATH=src python -m repro_torch.launch.recompute
"""
from __future__ import annotations

import json
import os
from glob import glob

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.traffic import modeled_bytes
from repro_torch.sharding import SERVE_RULES, TRAIN_RULES, AbstractMesh

ART = D.ART_DIR


def main() -> None:
    n = 0
    for path in sorted(glob(os.path.join(os.path.abspath(ART), "*",
                                         "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "cost_extrapolated" not in rec:
            continue
        cfg = D._apply_overrides(get_config(rec["arch"]),
                                 rec.get("overrides"))
        shape = SHAPES[rec["shape"]]
        multi = rec["mesh"] == "multi"
        mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                            ("pod", "data", "model") if multi
                            else ("data", "model"))
        rules = TRAIN_RULES if shape.kind == "train" else SERVE_RULES
        rec["modeled_bytes"] = modeled_bytes(cfg, shape, mesh, rules,
                                             shape.kind)
        rec["roofline"] = D.roofline(rec, 512 if multi else 256, cfg)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    print(f"recomputed {n} artifacts")


if __name__ == "__main__":
    main()
