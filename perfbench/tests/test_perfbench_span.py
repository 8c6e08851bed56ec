"""The traced span's rule: it opens with the window and runs on past it
until it holds the mix's minimum of admissions, installs and decode
steps; and a profile whose launch counts disagree with the kernels'
counters or the span's prefills, or whose layout gives the install
kernel no page or more than the configuration's, is the harness's
fault."""
import pytest

from perfbench import harness, trace_reduce, yardstick
from perfbench.tests import small


def test_short_span_extends_past_the_window():
    c, cfg = small.cell("qwen2-moe-a2.7b")
    c.mix["trace_span"] = {"admissions": 5, "installs": 5,
                           "decode_steps": 30}
    out = harness.serve(c, 4242, 0.0, True, "cpu", port_cfg=cfg)
    span = out.span
    assert span.closed and not span.is_open
    assert len(span.prefills) >= 5 and len(span.decodes) >= 30
    assert span.counters["installed"] >= 5
    # the window closed at its first step; the span ran on to fill
    assert out.view.window_s < span.t_close - span.t_open
    names = {s["name"] for s in out.view.spans}
    assert {"serve.prefill", "serve.install"} <= names
    # the wrappers are gone once the span closed
    assert out.view.profile is not None and out.view.profile.window_s > 0
    # the layout gives the install kernel the whole page: each layer's
    # K and V at max_len rows and its length
    assert out.view.install_page_bytes == \
        yardstick.page_bytes(c.spec, c.mix["max_len"])


def _view(flash_prof=56, flash_count=56, install_prof=2, install_count=2,
          prefills=2, installed=3, page_bytes=4096):
    ops = [trace_reduce.DeviceOp("void flash_attention_bf16_kernel<128>()",
                                 10 + i, 11 + i) for i in range(flash_prof)]
    ops += [trace_reduce.DeviceOp("install_pages_kernel<long>(InstallTable)",
                                  100 + i, 101 + i)
            for i in range(install_prof)]
    prof = trace_reduce.Profile(0, 1000, device=ops)
    spans = [{"name": "serve.prefill", "t0": i, "t1": i + 0.5, "args": {}}
             for i in range(prefills)]
    spans += [{"name": "serve.install", "t0": 5, "t1": 5.1,
               "args": {"path": "fused", "slots": installed}}]
    return harness.RunView(
        spec=small.cell("qwen2-vl-7b")[0].spec, mix={"max_len": 64},
        profile=prof, spans=spans, install_page_bytes=page_bytes,
        prefills=[(i + 0.1, i + 0.2, 1000, 28) for i in range(prefills)],
        counters={"flash": flash_count, "install": install_count,
                  "installed": installed})


def test_matching_launches_pass():
    harness.check_launches(_view())


@pytest.mark.parametrize("kw,word", [
    ({"flash_prof": 55}, "flash: 55 in the profile"),
    ({"flash_count": 84, "flash_prof": 84}, "for the span's 2 prefills"),
    ({"install_prof": 1}, "install: 1 in the profile"),
    ({"installed": 4, "install_count": 2}, None),
    ({"page_bytes": 0}, "the layout gives the kernel 0 B a page"),
    ({"page_bytes": 1 << 30}, "the configuration's whole page"),
])
def test_launch_mismatch_fails(kw, word):
    v = _view(**kw)
    if word is None:        # slots counted != slots in the spans
        v.counters["installed"] = 5
        word = "slots in serve.install spans"
    with pytest.raises(harness.HarnessFault, match=word):
        harness.check_launches(v)
