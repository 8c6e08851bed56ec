"""The port's channel and path benchmarks against the reference's: the
projection model, the pool's convenience transfers, the rows each twin
emits, and the overlap sweep's serves on the same float32 params."""
import dataclasses
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import completion_modes as ref_completion  # noqa: E402
from benchmarks import contention as ref_contention  # noqa: E402
from benchmarks import host_device_bw as ref_bw  # noqa: E402
from benchmarks import overlap as ref_overlap  # noqa: E402
from benchmarks import rdma_analogue as ref_rdma  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.core import analytical as ref_an  # noqa: E402
from repro.core.channels import Direction as RefDirection  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.benchmarks import completion_modes  # noqa: E402
from repro_torch.benchmarks import contention, host_device_bw  # noqa: E402
from repro_torch.benchmarks import overlap, rdma_analogue  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.configs import reduce_for_smoke as port_reduce  # noqa: E402
from repro_torch.core import analytical as an  # noqa: E402
from repro_torch.core.channels import ChannelPool, Direction  # noqa: E402

PAPER_MODELS = ["paper_pcie_ddr4", "paper_pcie_bram", "far_memory_path"]


@pytest.mark.parametrize("model", PAPER_MODELS)
@pytest.mark.parametrize("direction", ["h2c", "c2h"])
def test_project_equals_reference(model, direction):
    """``project`` over the reference's sizes and channel counts, for
    measurements below, at and above the ceiling."""
    got_m, want_m = getattr(an, model)(), getattr(ref_an, model)()
    for size in ref_bw.SIZES:
        for nch in ref_bw.CHANNELS:
            for meas, ceiling in ((1.7, 9.3), (9.3, 9.3), (52.0, 17.5)):
                got = an.project(meas, ceiling, got_m, size, nch,
                                 Direction(direction))
                want = ref_an.project(meas, ceiling, want_m, size, nch,
                                      RefDirection(direction))
                assert got == pytest.approx(want, rel=1e-9, abs=0)


def test_d2d_stand_in_reaches_its_measured_copy_rate():
    """One copy engine moves the whole measured rate: a large single
    copy approaches the anchor, a small one pays the measured setup."""
    m = an.h100_d2d_path()
    assert (m.link_gbps, m.t0_us) == (an.H100_D2D_COPY_GBPS,
                                      an.H100_D2D_T0_US)
    assert an.bandwidth_gbps(m, 1 << 36, 1, Direction.H2C) == \
        pytest.approx(m.link_gbps, rel=1e-3)
    small = 4096
    assert an.bandwidth_gbps(m, small, 1, Direction.H2C) == pytest.approx(
        small / ((m.t0_us * 1e-6 + small / (m.link_gbps * 1e9)) * 1e9))


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint8])
@pytest.mark.parametrize("n_channels", [1, 3])
def test_h2c_c2h_drain_round_trip_bytes(dtype, n_channels):
    rng = np.random.default_rng(3)
    arrs = [rng.integers(0, 200, size=(n, 33)).astype(dtype)
            for n in (1, 17, 4096)]
    with ChannelPool(n_channels, device="cpu", chunk_bytes=1 << 12) as pool:
        devs = pool.drain([pool.h2c(a) for a in arrs])
        assert all(isinstance(d, torch.Tensor) for d in devs)
        back = pool.drain([pool.c2h(d) for d in devs])
    for a, b in zip(arrs, back):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert np.array_equal(b.view(np.uint8), a.view(np.uint8))


def _keys(derived: str):
    return [m.group(1) for m in re.finditer(r"(\w+)=", derived)]


def _rows(rows_list, n0):
    return [r.split(",", 2) for r in rows_list[n0:]]


# reference column -> the port's (None: dropped); port-only columns
RENAMED = {"host_device_bw": ({"proj_tpu": "h100_model"}, ()),
           "rdma_analogue": ({"ici_model": "d2d_model"}, ("peer",)),
           "contention": ({}, ("burner",)),
           "completion_modes": ({}, ())}


@pytest.mark.parametrize("name,ref_mod,port_mod", [
    ("host_device_bw", ref_bw, host_device_bw),
    ("rdma_analogue", ref_rdma, rdma_analogue),
    ("contention", ref_contention, contention),
    ("completion_modes", ref_completion, completion_modes)])
def test_quick_rows_match_reference(name, ref_mod, port_mod):
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    ref_mod.run(quick=True)
    port_mod.run(quick=True, device="cpu")
    want, got = _rows(ref_common.ROWS, n_ref), _rows(common.ROWS, n_port)
    assert [r[0] for r in got] == [r[0] for r in want]
    rename, extra = RENAMED[name]
    for g, w in zip(got, want):
        keys = [rename.get(k, k) for k in _keys(w[2])] + list(extra)
        assert sorted(_keys(g[2])) == sorted(keys), (g, w)


@pytest.fixture(scope="module")
def overlap_setup():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              dtype="float32")
    pcfg = dataclasses.replace(port_reduce(port_config("qwen2-0.5b")),
                               dtype="float32")
    params = T.tree_init(T.param_defs(cfg), cfg, jax.random.PRNGKey(0))
    pparams = interop.tree_to_torch(jax.tree.map(np.asarray, params))
    return cfg, params, pcfg, pparams


@pytest.mark.parametrize("path,slots,lat", [("xdma", 2, 0.0),
                                            ("verbs", 4, 0.01)])
@pytest.mark.parametrize("mode", ["serial", "overlap"])
def test_overlap_serves_give_reference_outputs(overlap_setup, path, slots,
                                               lat, mode):
    cfg, params, pcfg, pparams = overlap_setup
    args = (path, slots, mode == "overlap", 6, 4, 8)
    want = ref_overlap._serve_once(cfg, params, *args, node_latency_s=lat)
    got = overlap._serve_once(pcfg, pparams, *args, node_latency_s=lat,
                              device="cpu")
    assert got["outputs"] == want["outputs"]
    assert got["tokens"] == want["tokens"] and got["undrained"] == 0
    assert got["overlap_installs"] + got["blocking_installs"] == \
        want["overlap_installs"] + want["blocking_installs"]


def test_overlap_quick_sweep_rows_and_keys_match_reference():
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_overlap.run(quick=True)
    got = overlap.run(quick=True, device="cpu", smoke=True)
    assert [r[0] for r in _rows(common.ROWS, n_port)] == \
        [r[0] for r in _rows(ref_common.ROWS, n_ref)]
    assert set(got["overlap"]) == set(want["overlap"])
    assert [set(r) for r in got["overlap"]["rows"]] == \
        [set(r) for r in want["overlap"]["rows"]]
    assert got["overlap"]["bit_exact"] is True
    assert got["overlap"]["undrained"] == 0
