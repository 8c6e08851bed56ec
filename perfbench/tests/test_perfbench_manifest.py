"""BENCHMARK.json against the benchmark's contract: names, units and
sources in their charsets, every per-layer metric's cells reporting the
end-to-end metric it moves, and every name backed by its file."""
import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
RAW = (ROOT / "BENCHMARK.json").read_text()
M = json.loads(RAW)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {w["name"]: w for w in M["workloads"]}
E2E = {m["name"]: m for m in M["end_to_end"]}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(RAW.encode()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    for w in M["command"]:
        assert line_ok(w) and not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in M["paths"])
            assert (ROOT / w).exists()


def test_run_seconds_fits_a_full_check():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line_ok(w["why"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == \
        len(M["workloads"])
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        E2E["setup_s"]
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"])


def _reports(cell, metric):
    m = E2E[metric]
    return "workloads" not in m or cell in m["workloads"]


def test_each_per_layer_metric_cells_report_what_it_moves():
    layers = {}
    for m in M["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        cells = m.get("workloads") or [c for c in CELLS
                                       if _reports(c, m["moves"])]
        assert cells
        for c in cells:
            assert c in CELLS and _reports(c, m["moves"]), (m["name"], c)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in CELLS:
        e2e = [n for n in E2E if _reports(c, n)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(c in m.get("workloads", CELLS) for m in M["per_layer"])
    for m in M["end_to_end"]:
        for c in m.get("workloads", []):
            assert c in CELLS


def test_every_name_has_its_file():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in cfg
    for w in M["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert {"max_logit_gap", "failed_requests"} <= set(lim)
    for m in M["end_to_end"] + M["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        tree = ast.parse(path.read_text())
        consts = {t.targets[0].id: t.value.value for t in tree.body
                  if isinstance(t, ast.Assign)
                  and isinstance(t.value, ast.Constant)}
        assert consts["UNIT"] == m["unit"] and consts["SOURCE"] == \
            m["source"], m["name"]


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_reduced_names_no_width(c):
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|"
                        r"_rank$|head|expansion|experts_per_tok)")
    for k in c["reduced"]:
        assert not widths.search(k), k
