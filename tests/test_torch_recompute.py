"""The port's recompute (``repro_torch/launch/recompute.py``) against the
reference's on two copies of one synthetic artifact folder whose
``modeled_bytes`` and ``roofline`` are stale: the port's re-derived
``modeled_bytes`` are the reference's, and its ``roofline`` the
reference's once the reference's three constants are the port's
(``tests/test_torch_dryrun.py``'s roofline test).  The records recompute
passes over (skipped, failed, multi-pod without cost) stay as they were,
byte for byte, and both print the same count.  The one known
difference is exact: an rwkv6-1.6b decode cell, whose ``state_rw`` term
the reference charges for its dead ``mix.cm_x`` cache leaf
(ROADMAP C.3, ``tests/test_torch_traffic.py``).

The reference runs in a subprocess: importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` (``src/repro/launch/dryrun.py:1-2``)."""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_ranks import SRC  # noqa: E402

from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import recompute as PR  # noqa: E402
from repro_torch.launch import traffic as PT  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402

REF = r"""
import json, sys
import repro.launch.recompute as RR
RR.ART = sys.argv[1]
RR.D.PEAK_FLOPS, RR.D.HBM_BW, RR.D.ICI_BW = (float(x) for x in sys.argv[2:5])
RR.main()
"""

STALE_BYTES = {"params": 1, "activations": 2, "state_rw": 3, "total": 6}
STALE_ROOF = {"compute_s": 9.0, "memory_s": 9.0, "collective_s": 9.0,
              "dominant": "compute_s", "model_flops": 1,
              "useful_flops_ratio": 9.0, "roofline_fraction": 9.0}
# (file, arch, shape, mesh, overrides, cost): cost (flops, bytes
# accessed, collective bytes) or None for a record without it
CELLS = [
    ("single/qwen2-0.5b__train_4k.json", "qwen2-0.5b", "train_4k",
     "single", [], (1.2e14, 3.1e12, 8.9e9)),
    ("single/llama3-8b__decode_32k.json", "llama3-8b", "decode_32k",
     "single", ["kv_dtype=int8"], (3.1e11, 2e11, 0.0)),
    ("single/qwen2-moe-a2.7b__prefill_32k.json", "qwen2-moe-a2.7b",
     "prefill_32k", "single", [], (2.5e13, 1e12, 4e9)),
    ("single/rwkv6-1.6b__decode_32k.json", "rwkv6-1.6b", "decode_32k",
     "single", [], (4.4e11, 0.0, 2.5e7)),
    ("multi/recurrentgemma-2b__train_4k.json", "recurrentgemma-2b",
     "train_4k", "multi", [], (9.5e13, 2e12, 1.1e10)),
    ("multi/qwen2-0.5b__train_4k.json", "qwen2-0.5b", "train_4k",
     "multi", [], None),
]


def _record(arch, shape, mesh, overrides, cost, status="ok"):
    sh = SHAPES[shape]
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": sh.kind,
           "overrides": overrides, "status": status,
           "tokens": sh.global_batch * (sh.seq_len if sh.kind != "decode"
                                        else 1)}
    if status != "ok":
        return rec
    rec["full"] = {"compile_s": 12.5, "flops": 1.0, "memory": {}}
    if cost is not None:
        rec["cost_extrapolated"] = dict(zip(
            ("flops", "bytes_accessed", "collective_bytes_per_device"),
            cost))
        rec["cost_points"] = [rec["full"]]
        rec["modeled_bytes"] = dict(STALE_BYTES)
        rec["roofline"] = dict(STALE_ROOF)
    return rec


def _folder(root) -> dict:
    """The synthetic folder under ``root``: {relative path: bytes}."""
    recs = {f: _record(*c) for f, *c in CELLS}
    skip = _record("qwen2-0.5b", "long_500k", "single", [], None,
                   "skipped")
    skip["reason"] = "pure full-attention arch"
    recs["single/qwen2-0.5b__long_500k.json"] = skip
    fail = _record("glm4-9b", "prefill_32k", "single", [], None, "failed")
    fail["error"] = "RuntimeError: planted"
    recs["single/glm4-9b__prefill_32k.json"] = fail
    out = {}
    for rel, rec in recs.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = json.dumps(rec, indent=2)      # not recompute's indent
        with open(path, "w") as f:
            f.write(data)
        out[rel] = data
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' recompute over a copy each of one folder: (the
    folder's files as written, {package: (stdout, {rel: text})})."""
    root = tmp_path_factory.mktemp("recompute")
    src = root / "src"
    written = _folder(str(src))
    ref, port = root / "ref", root / "port"
    shutil.copytree(src, ref)
    shutil.copytree(src, port)
    res = subprocess.run(
        [sys.executable, "-c", REF, str(ref), repr(D.PEAK_FLOPS),
         repr(D.HBM_BW), repr(D.LINK_BW)],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setattr(PR, "ART", str(port))
        PR.main()
    read = lambda d: {rel: open(os.path.join(d, rel)).read()
                      for rel in written}
    return written, {"ref": (res.stdout, read(ref)),
                     "port": (buf.getvalue(), read(port))}


def _dead_leaf_bytes(arch, shape) -> int:
    """What the reference's decode charges for ``mix.cm_x``: read and
    written in every RWKV layer at its local size on the (16, 16) mesh
    (the one RWKV record is single-pod)."""
    cfg, sh = get_config(arch), SHAPES[shape]
    if cfg.rwkv is None or sh.kind != "decode":
        return 0
    mesh = S.AbstractMesh((16, 16), ("data", "model"))
    d = ParamDef((sh.global_batch, cfg.d_model), ("batch", None))
    return 2 * cfg.n_layers * PT._tree_local_bytes({"cm_x": d}, cfg, mesh,
                                                   S.SERVE_RULES)


def test_both_print_the_same_count(runs):
    _, out = runs
    assert out["port"][0] == out["ref"][0] == "recomputed 5 artifacts\n"


def test_passed_over_records_stay_byte_equal(runs):
    written, out = runs
    for rel in ("multi/qwen2-0.5b__train_4k.json",
                "single/qwen2-0.5b__long_500k.json",
                "single/glm4-9b__prefill_32k.json"):
        assert out["port"][1][rel] == out["ref"][1][rel] == written[rel]


@pytest.mark.parametrize("rel", [c[0] for c in CELLS if c[-1] is not None])
def test_recomputed_fields_are_the_references(runs, rel):
    _, out = runs
    port, ref = (json.loads(out[k][1][rel]) for k in ("port", "ref"))
    assert out["port"][1][rel] == json.dumps(port, indent=1)
    assert port["modeled_bytes"] != STALE_BYTES
    assert port["roofline"] != STALE_ROOF
    _, arch, shape, *_ = next(c for c in CELLS if c[0] == rel)
    dead = _dead_leaf_bytes(arch, shape)
    mb = dict(port["modeled_bytes"])
    for k in ("activations", "total"):
        mb[k] += dead
    assert mb == ref["modeled_bytes"]
    if not dead:
        assert port == ref
        return
    # C.3: only the memory term (and what it decides) reads the leaf
    assert dead > 0
    pr, rr = port["roofline"], ref["roofline"]
    for k in ("compute_s", "collective_s", "model_flops",
              "useful_flops_ratio"):
        assert pr[k] == rr[k]
    assert pr["memory_s"] == port["modeled_bytes"]["total"] / D.HBM_BW
    assert rr["memory_s"] == ref["modeled_bytes"]["total"] / D.HBM_BW
    assert {k: v for k, v in port.items()
            if k not in ("modeled_bytes", "roofline")} == \
        {k: v for k, v in ref.items()
         if k not in ("modeled_bytes", "roofline")}


def test_overrides_reach_the_modeled_bytes(runs):
    """The int8 KV cache of the overridden record is what recompute
    charged: not the bf16 cache of the arch's own config."""
    _, out = runs
    rec = json.loads(out["port"][1]["single/llama3-8b__decode_32k.json"])
    mesh = S.AbstractMesh((16, 16), ("data", "model"))
    plain = PT.modeled_bytes(get_config("llama3-8b"), SHAPES["decode_32k"],
                             mesh, S.SERVE_RULES, "decode")
    assert rec["overrides"] == ["kv_dtype=int8"]
    assert rec["modeled_bytes"]["total"] < plain["total"]


def test_recompute_reads_the_ports_folder():
    """Its default folder is the dry run's, ``experiments/dryrun_torch``,
    never the reference's ``experiments/dryrun``."""
    assert PR.ART == D.ART_DIR
    assert os.path.normpath(PR.ART).endswith(
        os.path.join("experiments", "dryrun_torch"))
