"""Every metric a cell declares is on its last line, built from
synthetic profiler and span records; a reader that finds nothing stops
the run, naming the metric, instead of printing a line without it."""
import json
from pathlib import Path

import pytest

from perfbench import harness, trace_reduce, yardstick

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def synthetic(cell: harness.Cell) -> harness.RunView:
    """Two prefills of 3000 and 5000 tokens, three installed pages in
    two launches, sixty decode steps, and a profile with their kernels
    among others."""
    L = cell.spec["L"]
    ms = 1_000_000
    ops = [trace_reduce.DeviceOp("void flash_attention_bf16_kernel<128>()",
                                 i * ms, i * ms + ms)
           for i in range(2 * L)]
    ops += [trace_reduce.DeviceOp("void install_pages_kernel<int>()",
                                  (100 + 4 * i) * ms, (103 + 4 * i) * ms)
            for i in range(2)]
    ops += [trace_reduce.DeviceOp("sm90_xmma_gemm_bf16", (200 + 4 * i) * ms,
                                  (203 + 4 * i) * ms) for i in range(60)]
    ops += [trace_reduce.DeviceOp("Memcpy HtoD (Pinned -> Device)",
                                  600 * ms, 620 * ms)]
    host = [trace_reduce.HostEvent("engine.step", 180 * ms, 710 * ms),
            trace_reduce.HostEvent("engine.decode", 190 * ms, 700 * ms)]
    prof = trace_reduce.Profile(0, 1000 * ms, device=ops, host=host)
    prefills = [(0.0, 1.0, 3000, 0), (2.0, 3.5, 5000, 0)]
    spans = [{"name": "serve.prefill", "t0": -0.01, "t1": 1.1, "args": {}},
             {"name": "serve.prefill", "t0": 1.99, "t1": 3.6, "args": {}},
             {"name": "serve.install", "t0": 4.0, "t1": 4.01,
              "args": {"path": "fused", "slots": 1}},
             {"name": "serve.install", "t0": 5.0, "t1": 5.03,
              "args": {"path": "fused", "slots": 2}}]
    decodes = [(6 + 0.05 * i, 6.04 + 0.05 * i, [3000 + i] * 8)
               for i in range(60)]
    return harness.RunView(
        spec=cell.spec, mix=cell.mix, setup_s=41.5, window_s=40.0,
        ttft_s=[0.5 + 0.01 * i for i in range(100)],
        gaps_s=[0.04] * 1000 + [0.4] * 30, tokens=4000, prefills=prefills,
        decodes=decodes, spans=spans, profile=prof,
        counters={"flash": 2 * L, "install": 2, "installed": 3},
        install_page_bytes=yardstick.page_bytes(cell.spec, 4096))


def outcome(view):
    return harness.Outcome(view=view, attempted=100, failed=0, failed_all=0,
                           samples=[], memory_peak=1, span=None, params=None)


CHECKS = {"max_logit_gap": {"value": 0.01, "limit": 0.3},
          "mean_logit_error": {"value": 0.005, "limit": 0.05},
          "failed_requests": {"value": 0, "limit": 0},
          "served_tokens_checked": {"value": 300, "limit": 300}}


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_every_declared_metric_is_on_the_line(name, trace):
    cell = harness.load_cell(name)
    line = harness.result_line(cell, outcome(synthetic(cell)), trace,
                               CHECKS, "NVIDIA H100 80GB HBM3")
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in want:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
        if m["unit"] == "%":
            assert got["value"] <= 100.0
    assert list(line)[-1] == "checks"
    json.loads(json.dumps(line))
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert line["breakdown"]["idle_gaps"]


def test_reader_with_nothing_to_read_names_the_metric():
    cell = harness.load_cell("qwen2-vl-7b.longdoc")
    view = synthetic(cell)
    view.spans = [s for s in view.spans if s["name"] != "serve.install"]
    with pytest.raises(harness.HarnessFault, match="kv_fetch_wait_ms"):
        harness.result_line(cell, outcome(view), True, CHECKS, "x")


def test_synthetic_numbers_by_hand():
    cell = harness.load_cell("qwen2-moe-a2.7b.longdoc")
    view = synthetic(cell)
    s = cell.spec
    mfu = harness.load_reader("prefill_mfu").read(view)
    want = (yardstick.prefill_flops(s, 3000) + yardstick.prefill_flops(
        s, 5000)) / 2.5 / 989e12 * 100
    assert mfu == pytest.approx(want)
    # serve.prefill less the call: 1.11 - 1.0 and 1.61 - 1.5
    assert harness.load_reader("kv_spill_ms").read(view) == \
        pytest.approx(1e3 * 0.11)
    assert harness.load_reader("kv_fetch_wait_ms").read(view) == \
        pytest.approx(1e3 * 0.04 / 3)
    # 48 flash launches of 1 ms against 24 layers' bounds
    bound = 24 * (yardstick.flash_bound_s(s, 3000)
                  + yardstick.flash_bound_s(s, 5000))
    assert harness.load_reader("flash_roofline").read(view) == \
        pytest.approx(100 * bound / 48e-3)
    # three pages of the layout's bytes, read and written, over 6 ms
    assert harness.load_reader("install_roofline").read(view) == \
        pytest.approx(100 * 2 * 3 * view.install_page_bytes / 3.35e12 / 6e-3)
    busy = 48 + 6 + 60 * 3 + 20      # ms, no overlap
    assert harness.load_reader("device_idle_pct").read(view) == \
        pytest.approx(100 * (1 - busy / 1000))


@pytest.mark.parametrize("raw,short", [
    ("void (anonymous namespace)::install_pages_kernel<long>(InstallTable)",
     "install_pages_kernel"),
    ("void flash_attention_bf16_kernel<128>(CUtensorMap, FaParams)",
     "flash_attention_bf16_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl<>(at::TensorIteratorBase&)::{lambda(int)#1}>(int, F)",
     "at::native::elementwise_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD")])
def test_kernel_short_names(raw, short):
    assert trace_reduce.short_name(raw) == short
