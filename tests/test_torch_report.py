"""The port's report (``repro_torch/launch/report.py``) against the
reference's on one synthetic artifact folder: the tables and the perf
section are the reference's text, character for character; the
document around them is the port's, with the H100 constants and no TPU
statement.  Both packages read the folder under ``tmp_path`` and write
their documents there: the reference's ``ROOT``, ``ART`` and ``PERF``
are pointed at it, so the repository's own ``EXPERIMENTS.md`` is never
written."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as R  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import report as P  # noqa: E402

REPO_DOC = os.path.join(os.path.dirname(__file__), "..", "EXPERIMENTS.md")


def _base(arch, shape, mesh, status="ok"):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "kind": SHAPES[shape].kind, "overrides": [], "tokens": 4096,
            "status": status}


def _full(compile_s, arg, temp, coll):
    return {"compile_s": compile_s,
            "memory": {"argument_size_in_bytes": arg,
                       "output_size_in_bytes": 1024,
                       "temp_size_in_bytes": temp,
                       "alias_size_in_bytes": 512,
                       "generated_code_size_in_bytes": 0},
            "flops": 1.5e14, "bytes_accessed": 3.25e12,
            "collective_bytes_per_device": 8.5e9,
            "collectives": {k: {"count": n, "operand_bytes": b}
                            for k, (n, b) in coll.items()},
            "hlo_chars": 123456}


def _ok(arch, shape, mesh, compile_s, roof=None):
    rec = _base(arch, shape, mesh)
    rec["full"] = _full(compile_s, 46339972, 21.5e9,
                        {"reduce-scatter": (48, 2.5e9),
                         "all-gather": (96, 6e9),
                         "all-reduce": (3.0, 1e6)})
    if roof is not None:
        rec["cost_extrapolated"] = {"flops": 1.5e14,
                                    "bytes_accessed": 3.25e12,
                                    "collective_bytes_per_device": 8.5e9}
        rec["cost_points"] = [rec["full"]]
        rec["modeled_bytes"] = {"total": 5.5e10}
        rec["roofline"] = roof
    return rec


ROOF_A = {"compute_s": 0.15166835187057634, "memory_s": 0.016417910447761194,
          "collective_s": 0.17, "dominant": "collective_s",
          "model_flops": 2.9638426470400004e+18,
          "useful_flops_ratio": 0.07718340226666667,
          "roofline_fraction": 0.06886278213824165}
ROOF_B = {"compute_s": 0.00031345, "memory_s": 0.0213846,
          "collective_s": 0.0004, "dominant": "memory_s",
          "model_flops": 2.05e12, "useful_flops_ratio": 1.0,
          "roofline_fraction": 0.0004565}

SKIP_REASON = shape_applicable(get_config("qwen2-0.5b"),
                               SHAPES["long_500k"])[1]
FAIL_ERROR = ("RuntimeError: the planted failure of a synthetic cell, "
              "written longer than sixty characters on purpose")

PERF_LOG = [
    {"cell": "qwen2-0.5b/train_4k", "title": "collective-bound baseline",
     "why": "the largest collective term of the single-pod cells",
     "iterations": [
         {"hypothesis": "fewer all-gathers", "change": "--set remat=none",
          "before": "collective 0.170 s", "after": "collective 0.121 s",
          "verdict": "kept"},
         {"hypothesis": "bf16 grads", "change": "grad dtype",
          "before": "0.121 s", "after": "0.120 s", "verdict": "dropped"}],
     "summary": "one change of two kept"},
    {"cell": "llama3-8b/decode_32k", "title": "memory-bound decode",
     "iterations": [
         {"hypothesis": "int8 KV", "change": "--set kv_dtype=int8",
          "before": "memory 0.0214 s", "after": "memory 0.0109 s",
          "verdict": "kept"}]},
]


def _write(path, rec):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


@pytest.fixture()
def folder(tmp_path, monkeypatch):
    """The synthetic artifact folder and perf log, and both packages'
    report modules pointed at them."""
    art = tmp_path / "dryrun"
    single, multi = art / "single", art / "multi"
    _write(single / "qwen2-0.5b__train_4k.json",
           _ok("qwen2-0.5b", "train_4k", "single", 41.3, ROOF_A))
    _write(single / "llama3-8b__decode_32k.json",
           _ok("llama3-8b", "decode_32k", "single", 7.9, ROOF_B))
    _write(multi / "qwen2-0.5b__train_4k.json",
           _ok("qwen2-0.5b", "train_4k", "multi", 52.6))
    skip = _base("qwen2-0.5b", "long_500k", "single", "skipped")
    skip["reason"] = SKIP_REASON
    _write(single / "qwen2-0.5b__long_500k.json", skip)
    _write(multi / "qwen2-0.5b__long_500k.json",
           dict(skip, mesh="multi"))
    fail = _base("glm4-9b", "prefill_32k", "single", "failed")
    fail.update(error=FAIL_ERROR, traceback="Traceback ...")
    _write(single / "glm4-9b__prefill_32k.json", fail)
    # a tagged variant of the first cell: in neither table
    _write(single / "qwen2-0.5b__train_4k__tag.json",
           _ok("qwen2-0.5b", "train_4k", "single", 99.7,
               dict(ROOF_A, roofline_fraction=0.4321)))
    # an arch outside ARCH_ORDER: loaded, in no table
    _write(single / "mystery-1b__train_4k.json",
           _ok("mystery-1b", "train_4k", "single", 3.3, ROOF_B))
    perf = tmp_path / "perf_log.json"
    perf.write_text(json.dumps(PERF_LOG))
    monkeypatch.setattr(R, "ROOT", str(tmp_path / "ref"))
    monkeypatch.setattr(R, "ART", str(art))
    monkeypatch.setattr(R, "PERF", str(perf))
    monkeypatch.setattr(P, "ART", str(art))
    monkeypatch.setattr(P, "PERF", str(perf))
    monkeypatch.setattr(P, "OUT", str(tmp_path / "port" / "EXPERIMENTS.md"))
    (tmp_path / "ref").mkdir()
    return tmp_path


def test_synthetic_folder_is_what_the_tables_probe(folder):
    assert len(SKIP_REASON) > 60 and len(FAIL_ERROR) > 60
    assert "mystery-1b" not in P.ARCH_ORDER
    assert P.ARCH_ORDER == R.ARCH_ORDER and P.SHAPE_ORDER == R.SHAPE_ORDER
    assert set(P.load("single")) == set(R.load("single")) == {
        ("qwen2-0.5b", "train_4k"), ("llama3-8b", "decode_32k"),
        ("qwen2-0.5b", "long_500k"), ("glm4-9b", "prefill_32k"),
        ("mystery-1b", "train_4k")}
    # the tagged copy is skipped, not read over the baseline
    assert P.load("single")[("qwen2-0.5b", "train_4k")]["full"][
        "compile_s"] == 41.3


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_table_is_the_references_text(folder, mesh):
    got = P.dryrun_table(P.load(mesh), mesh)
    assert got == R.dryrun_table(R.load(mesh), mesh)
    assert "| SKIP |" in got and "mystery-1b" not in got
    assert "99.7" not in got


def test_roofline_table_is_the_references_text(folder):
    got = P.roofline_table(P.load("single"))
    assert got == R.roofline_table(R.load("single"))
    rows = got.splitlines()[2:]
    assert [r.split(" | ")[0] for r in rows] == ["| qwen2-0.5b",
                                                 "| llama3-8b"]
    assert f"**{ROOF_A['roofline_fraction']:.3f}**" in rows[0]
    assert "0.432" not in got


@pytest.mark.parametrize("with_log", [True, False])
def test_perf_section_is_the_references_text(folder, with_log):
    if not with_log:
        os.remove(P.PERF)
    assert P.perf_section() == R.perf_section()
    if not with_log:
        assert P.perf_section() == "_perf log not yet recorded_"


@pytest.mark.parametrize("b", [0, 46339972, 21.5e9, 3.125e12])
def test_fmt_bytes_is_the_references(b):
    assert P.fmt_bytes(b) == R.fmt_bytes(b)


def test_document_is_the_ports_with_the_references_tables(folder, capsys):
    before = open(REPO_DOC, "rb").read() if os.path.exists(REPO_DOC) \
        else None
    R.main()
    P.main()
    out = capsys.readouterr().out
    assert "(3+1 single, 1+1 multi cells)" in out
    ref_doc = (folder / "ref" / "EXPERIMENTS.md").read_text()
    doc = open(P.OUT).read()
    for table in (R.dryrun_table(R.load("single"), "single"),
                  R.dryrun_table(R.load("multi"), "multi"),
                  R.roofline_table(R.load("single")), R.perf_section()):
        assert table in ref_doc and table in doc
    assert "### Single-pod (16,16): 3 ok / 1 required-skip" in doc
    assert "### Multi-pod (2,16,16): 1 ok / 1 required-skip" in doc
    for c in ("989e12", "3.35e12", "50e9"):
        assert c in doc
    assert (D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert "197" not in doc and "TPU" not in doc
    assert "repro_torch.benchmarks.run" in doc
    after = open(REPO_DOC, "rb").read() if os.path.exists(REPO_DOC) \
        else None
    assert after == before
