"""The port's far-memory sweep against the reference's: row names, the
miss pipeline's and the eviction sweep's byte counts, the path selector
against the port's own models, and each access path's serve on the same
float32 params."""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import far_memory as ref_fm  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common, far_memory  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch.serve import draw_prompts  # noqa: E402

TIMED = {"serial_s", "pipelined_s", "prefetched_s", "speedup",
         "projected_gbps"}


def _names(rows, n0):
    return [r.split(",", 1)[0] for r in rows[n0:]]


@pytest.fixture(scope="module")
def quick_runs():
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_fm.run(quick=True)
    ref_names = _names(ref_common.ROWS, n_ref)
    got = far_memory.run(quick=True, device="cpu")
    return want, ref_names, got, _names(common.ROWS, n_port)


def test_quick_row_names_match_reference(quick_runs):
    _, ref_names, _, names = quick_runs
    assert names == ref_names
    assert set(quick_runs[2]) == set(quick_runs[0])


def test_miss_pipeline_moves_the_reference_bytes(quick_runs):
    want, _, got, _ = quick_runs
    w, g = want["miss_pipeline"], got["miss_pipeline"]
    assert (g["page_bytes"], g["n_miss"]) == (w["page_bytes"], w["n_miss"])
    assert len(g["rows"]) == len(w["rows"])
    for gr, wr in zip(g["rows"], w["rows"]):
        assert set(gr) == set(wr)
        assert {k: v for k, v in gr.items() if k not in TIMED} == \
            {k: v for k, v in wr.items() if k not in TIMED}


def test_eviction_sweep_equals_reference(quick_runs):
    want, _, got, _ = quick_runs
    assert got["dirty_sweep"] == want["dirty_sweep"]
    for r in got["dirty_sweep"]:
        dirty = r["evictions"] - r["clean_evictions"]
        assert r["writeback_bytes"] == r["c2h_bytes"] == \
            dirty * far_memory.DIRTY_PAGE_BYTES
        if r["dirty_ratio"] == 0.0:
            assert r["writeback_bytes"] == 0


def test_path_selection_follows_the_ports_model():
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_fm._path_select_rows(quick=True)
    got = far_memory._path_select_rows(True, "cpu")
    assert _names(common.ROWS, n_port) == _names(ref_common.ROWS, n_ref)
    assert got["all_match_model"] is True
    for row, ref_row in zip(got["rows"], want["rows"]):
        assert set(row) == set(ref_row)
        argmin = min(row["pinned"],
                     key=lambda n: row["pinned"][n]["projected_s"])
        assert row["chosen"] == row["model_argmin"] == argmin


@pytest.fixture(scope="module")
def serve_setup():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(2))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, params, pcfg, pparams


@pytest.mark.parametrize("path", ["xdma", "qdma", "verbs", "auto"])
def test_serve_gives_each_path_the_reference_outputs(monkeypatch,
                                                     serve_setup, path):
    """Each access path's serve, through the port's serve CLI with the
    reference's float32 weights swapped in, gives the reference engine's
    tokens on the CLI's seeded prompts."""
    cfg, params, pcfg, pparams = serve_setup
    monkeypatch.setattr(port_serve, "reduce_for_smoke", lambda c: pcfg)
    monkeypatch.setattr(port_serve.T, "tree_init",
                        lambda defs, c, seed, device: pparams)
    n_req, max_new = 4, 8
    eng = RefEngine(cfg, params, batch_slots=2, max_len=128,
                    access_path=path, kv_doorbell=4)
    prompts, _ = draw_prompts(0, n_req, 12, cfg.vocab)
    for r, p in enumerate(prompts):
        eng.submit(RefRequest(rid=r, prompt=p, max_new=max_new))
    assert eng.run_until_drained() == 0
    eng.pager.close()
    want = {r.rid: list(r.out_tokens) for r in eng.done}
    row, got = far_memory._serve_path(path, n_req, max_new, "cpu",
                                      smoke=True)
    assert got == want
    assert row["requests"] == n_req and row["h2c_bytes"] > 0


def test_json_artifacts_carry_metrics_and_seed(tmp_path):
    common.set_bench_seed(0)
    out, sel = tmp_path / "m.json", tmp_path / "s.json"
    far_memory.run(quick=True, out=str(out), select_out=str(sel),
                   device="cpu", smoke=True)
    m, s = json.loads(out.read_text()), json.loads(sel.read_text())
    assert set(m) == {"miss_pipeline", "dirty_sweep", "path_select",
                      "serve", "metrics", "seed"}
    assert set(s) == {"path_select", "serve", "metrics", "seed"}
    assert m["seed"] == 0
    assert set(m["serve"]) == {"xdma", "qdma", "verbs", "auto",
                               "auto_bit_exact"}
    assert m["serve"]["auto_bit_exact"] is True
