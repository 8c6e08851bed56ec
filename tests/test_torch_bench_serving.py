"""The port's serving benchmarks against the reference's: under
``--smoke`` on the CPU, ``serve_slo`` and ``kv_capacity`` emit the
reference's rows in its order with its derived fields and write its JSON
keys; their bit-exact fields hold; ``run.py`` takes both modules with
``--serve-slo-json`` and ``--kv-capacity-json``."""
import json
import re

import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import kv_capacity as ref_kv  # noqa: E402
from benchmarks import serve_slo as ref_slo  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.benchmarks import common, kv_capacity, serve_slo  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402


def _rows(rows_list, n0):
    # the codec rows' names hold a comma, their derived fields none
    return [r.rsplit(",", 2) if r.startswith("kv_") else r.split(",", 2)
            for r in rows_list[n0:]]


def _fields(derived):
    return [m.group(1) for m in re.finditer(r"(\w+)=", derived)]


def _keys(d):
    # "metrics" snapshots the process-wide registry: its keys follow what
    # earlier code in the process recorded
    return {k: _keys(v) if isinstance(v, dict) and k != "metrics" else None
            for k, v in d.items()}


def _run_both(ref_mod, port_mod, tmp_path):
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_mod.run(quick=True, out=str(tmp_path / "ref.json"))
    got = port_mod.main(["--smoke", "--device", "cpu", "--json",
                         str(tmp_path / "port.json")])
    rows = (_rows(ref_common.ROWS, n_ref), _rows(common.ROWS, n_port))
    files = [json.loads((tmp_path / n).read_text())
             for n in ("ref.json", "port.json")]
    return want, got, rows, files


def test_serve_slo_smoke_rows_and_keys_match_reference(tmp_path):
    want, got, (ref_rows, port_rows), (rj, pj) = _run_both(
        ref_slo, serve_slo, tmp_path)
    names = ["serve_slo/scaling/replicas1", "serve_slo/scaling/replicas2",
             "serve_slo/slo/baseline", "serve_slo/slo/policy",
             "serve_slo/kill"]
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows] == names
    assert [_fields(r[2]) for r in port_rows] == \
        [_fields(r[2]) for r in ref_rows]
    assert set(got) == set(want)
    assert set(pj) == set(rj) and set(pj["serve_slo"]) == \
        set(rj["serve_slo"])
    for pr, rr in zip(got["rows"], want["rows"]):
        assert set(pr) == set(rr)
        assert pr["scenario"] == rr["scenario"]
    assert got["kill_bit_exact"] is True and got["rerouted"] > 0
    kill = got["rows"][-1]
    assert kill["killed_member"] is not None
    assert kill["killed_replicas"] == ["replica1"]
    # the scaling rows serve the same seeded burst in both packages
    assert [r["tokens"] for r in got["rows"][:2]] == \
        [r["tokens"] for r in want["rows"][:2]]


def test_kv_capacity_smoke_rows_and_keys_match_reference(tmp_path):
    want, got, (ref_rows, port_rows), (rj, pj) = _run_both(
        ref_kv, kv_capacity, tmp_path)
    names = ["kv_codec[xdma,none]", "kv_codec[xdma,bf16]",
             "kv_codec[xdma,int8]", "kv_share_uplift", "kv_bitexact"]
    assert [r[0] for r in port_rows] == [r[0] for r in ref_rows] == names
    assert [_fields(r[2].replace(";", " ")) for r in port_rows] == \
        [_fields(r[2].replace(";", " ")) for r in ref_rows]
    assert _keys(got) == _keys(want)
    assert set(pj) == set(rj)
    g, w = got["gate"], want["gate"]
    assert g["bitexact_bf16"] is True and g["bitexact_share"] is True
    assert g["int8_spill_ratio"] == w["int8_spill_ratio"]
    for pr, rr in zip(got["codecs"], want["codecs"]):
        for k in ("path", "codec", "page_bytes", "phys_page_bytes",
                  "spill_bytes_logical", "spill_bytes_physical"):
            assert pr[k] == rr[k], k
    # the byte budget caps the unshared run at its page count; sharing
    # admits past it (the reference's 1.5x gate)
    off = got["share"]["off"]
    assert off["peak_active"] == off["capacity_pages"] == 4
    assert g["share_admit_uplift"] >= 1.5 and w["share_admit_uplift"] >= 1.5
    assert got["share"]["on"]["served"] == off["served"] == 16


def test_run_takes_serve_slo_and_kv_capacity_with_their_json(tmp_path):
    names = [n for n, _ in bench_run.MODULES]
    assert names.index("serve_slo") == names.index("chaos_soak") + 1
    assert names.index("kv_capacity") == names.index("install_path") + 1
    sj, kj = tmp_path / "s.json", tmp_path / "k.json"
    try:
        res = bench_run.main(["--smoke", "--device", "cpu", "--only",
                              "kv_capacity", "--serve-slo-json", str(sj),
                              "--kv-capacity-json", str(kj),
                              "--json", str(tmp_path / "m.json"),
                              "--select-json", str(tmp_path / "p.json"),
                              "--fabric-json", str(tmp_path / "f.json"),
                              "--chaos-json", str(tmp_path / "c.json"),
                              "--install-json", str(tmp_path / "i.json")])
    finally:
        obs.metrics.disable_live()
        obs.default_registry().clear()
    assert list(res) == ["kv_capacity"]
    assert json.loads(kj.read_text())["gate"]["bitexact_share"] is True
    assert not sj.exists()
