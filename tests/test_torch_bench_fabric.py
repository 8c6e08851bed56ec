"""The port's fabric and chaos benchmarks against the reference's: under
``--smoke`` on the CPU each twin emits the reference's rows in the
reference's order, with its derived fields, its JSON keys and its
``ok`` gates; the placement-derived numbers (pages re-copied by the
failover, the rebalance's moved fraction) equal the reference's, and
every gate the reference holds holds in the port; and ``run.py`` takes
both modules with their ``--fabric-json`` and ``--chaos-json``."""
import itertools
import json
import re

import pytest

torch = pytest.importorskip("torch")

from benchmarks import chaos as ref_chaos  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fabric as ref_fabric  # noqa: E402
from repro_torch.benchmarks import chaos, common, fabric  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402


def _rows(rows_list, n0):
    return [r.split(",", 2) for r in rows_list[n0:]]


def _fields(derived):
    return [m.group(1) for m in re.finditer(r"(\w+)=", derived)]


def _run_both(ref_mod, port_mod, tmp_path, port_argv):
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_mod.main(["--smoke", "--json", str(tmp_path / "ref.json")])
    got = port_mod.main(port_argv + ["--json",
                                     str(tmp_path / "port.json")])
    rows = (_rows(ref_common.ROWS, n_ref), _rows(common.ROWS, n_port))
    files = [json.loads((tmp_path / n).read_text())
             for n in ("ref.json", "port.json")]
    return want, got, rows, files


def test_fabric_smoke_rows_and_gates_match_reference(tmp_path):
    want, got, (ref_rows, port_rows), (rj, pj) = _run_both(
        ref_fabric, fabric, tmp_path, ["--smoke", "--device", "cpu"])
    names = ["fabric_baseline_verbs", "fabric_s1_r1", "fabric_s2_r1",
             "fabric_s4_r1", "fabric_s4_r2", "fabric_failover_s4_r2",
             "fabric_rebalance_4to5", "fabric_sweep_total"]
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows] == names
    assert [_fields(r[2]) for r in port_rows] == \
        [_fields(r[2]) for r in ref_rows]
    g, w = got["fabric"], want["fabric"]
    assert set(g) == set(w)
    assert set(pj) == set(rj) and set(pj["fabric"]) == set(rj["fabric"])
    assert [(r["shards"], r["replicas"]) for r in g["rows"]] == \
        [(r["shards"], r["replicas"]) for r in w["rows"]]
    # placement is arithmetic: the same pages move in both packages
    assert g["failover"]["victim"] == w["failover"]["victim"]
    assert g["failover"]["pages_recopied"] == \
        w["failover"]["pages_recopied"]
    assert g["rebalance"]["moved_pages"] == w["rebalance"]["moved_pages"]
    assert g["rebalance"]["moved_fraction"] == \
        w["rebalance"]["moved_fraction"]
    assert g["bit_exact"] and g["failover"]["lost"] == 0
    assert g["ok_rebalance"]
    for gate in ("ok_baseline", "ok_scaling", "ok"):
        if w[gate]:
            assert g[gate], gate


def test_chaos_smoke_rows_and_gates_match_reference(tmp_path, monkeypatch):
    # fault draws follow the scope names, which come from process-wide
    # counters: both packages start theirs at 0 (tests/test_torch_chaos.py)
    from repro.rmem import backend as ref_backend
    from repro.rmem import node as ref_node
    from repro_torch.rmem import backend as port_backend
    from repro_torch.rmem import node as port_node
    for cls in (ref_node.MemoryNode, port_node.MemoryNode,
                ref_backend.LocalHostBackend, port_backend.LocalHostBackend):
        monkeypatch.setattr(cls, "_scope_ids", itertools.count())
    want, got, (ref_rows, port_rows), (rj, pj) = _run_both(
        ref_chaos, chaos, tmp_path, ["--smoke", "--device", "cpu"])
    names = ["chaos_xdma_faults", "chaos_verbs_faults",
             "chaos_fabric_chaos", "chaos_sweep_total"]
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows] == names
    assert [_fields(r[2]) for r in port_rows] == \
        [_fields(r[2]) for r in ref_rows]
    g, w = got["chaos"], want["chaos"]
    assert set(g) == set(w) and set(pj["chaos"]) == set(rj["chaos"])
    for pr, rr in zip(g["rows"], w["rows"]):
        assert set(pr) == set(rr)
        assert (pr["cell"], pr["path"], pr["shards"], pr["replicas"],
                pr["faults"]) == (rr["cell"], rr["path"], rr["shards"],
                                  rr["replicas"], rr["faults"])
        assert pr["plan"]["seed"] == 7
    assert g["bit_exact"] and g["ok"] and w["ok"]
    assert g["p99_bound_s"] == w["p99_bound_s"]
    fabric_row = g["rows"][-1]
    assert fabric_row["shed"] == 0 and fabric_row["served"] == 8


def test_run_takes_fabric_and_chaos_with_their_json(tmp_path):
    names = [n for n, _ in bench_run.MODULES]
    assert names.index("fabric_sweep") == names.index("serve_overlap") + 1
    assert names.index("chaos_soak") == names.index("fabric_sweep") + 1
    fj, cj = tmp_path / "f.json", tmp_path / "c.json"
    res = bench_run.main(["--quick", "--device", "cpu", "--only",
                          "fabric_sweep", "--fabric-json", str(fj),
                          "--chaos-json", str(cj)])
    assert list(res) == ["fabric_sweep"]
    assert json.loads(fj.read_text())["fabric"]["bit_exact"] is True
    assert not cj.exists()
