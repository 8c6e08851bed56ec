"""The port's install-path bench against the reference's: the kernels'
bytes (plain versions on the CPU) against the reference's byte format,
the structural hop counts, the rows, and the runner's JSON."""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import install_path as ref_ip  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.benchmarks import common, install_path  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MAX_LEN = 64


def _ref_inputs():
    single, batch = ref_ip._trees(MAX_LEN)
    layout = ref_ops.page_layout(single, batch, ref_ip.BATCH)
    flat_b = jax.tree.leaves(ref_ip._randomize(batch, 4))
    leaves = jax.tree.leaves(ref_ip._randomize(single, 5))
    return layout, flat_b, leaves


def _u8(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def test_parity_inputs_are_the_references():
    rlayout, rflat, rleaves = _ref_inputs()
    layout, flat_b, leaves, slots = install_path.parity_inputs(
        MAX_LEN, "cpu", smoke=True)
    assert layout.page_bytes == rlayout.page_bytes
    assert slots == [3, 0]
    for got, want in zip(flat_b + leaves, rflat + rleaves):
        assert np.array_equal(_u8(got), _u8(want))


def test_pack_bytes_equal_the_reference_page():
    rlayout, _, rleaves = _ref_inputs()
    layout, _, leaves, _ = install_path.parity_inputs(MAX_LEN, "cpu", True)
    want = np.asarray(ref_ops.pack_page_ref(rlayout, rleaves))
    assert np.array_equal(ops.pack_page(layout, leaves).numpy(), want)
    assert np.array_equal(ops.pack_page_ref(layout, leaves).numpy(), want)


def test_install_bytes_equal_the_reference_install():
    rlayout, rflat, rleaves = _ref_inputs()
    layout, flat_b, leaves, slots = install_path.parity_inputs(
        MAX_LEN, "cpu", True)
    rpage = ref_ops.pack_page_ref(rlayout, rleaves)
    want = ref_ops.install_pages_ref(
        rlayout, rflat, jax.numpy.stack([jax.numpy.asarray(rpage)] * 2),
        slots)
    page = ops.pack_page(layout, leaves)
    got = ops.install_pages(layout, [b.clone() for b in flat_b],
                            torch.stack([page] * 2), slots)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(_u8(g), _u8(w))
    assert install_path._check_parity(MAX_LEN, "cpu", smoke=True) is True


def test_hop_counts_equal_the_reference():
    spill = install_path._bench_spill(MAX_LEN, "cpu", smoke=True)
    assert spill["d2h_hops_ref"] == ref_ip._bench_spill(MAX_LEN)[
        "d2h_hops_ref"]
    assert spill["d2h_hops_fused"] == 1
    staged = install_path._bench_staged_h2c("cpu")
    assert staged == ref_ip._bench_staged_h2c()


def test_chain_install_matches_the_plain_install():
    """The ``ref_us`` yardstick computes what ``install_pages`` does."""
    layout, flat_b, leaves, slots = install_path.parity_inputs(
        MAX_LEN, "cpu", True)
    pages = torch.stack([ops.pack_page_ref(layout, leaves)] * 2)
    want = ops.install_pages_ref(layout, [b.clone() for b in flat_b],
                                 pages, slots)
    got = [b.clone() for b in flat_b]
    install_path._chain_install(layout, got, pages,
                                [torch.tensor([s]) for s in slots])
    for g, w in zip(got, want):
        assert np.array_equal(_u8(g), _u8(w))


def test_runner_smoke_rows_and_json_match_reference(tmp_path):
    n_ref, n_port = len(ref_common.ROWS), len(common.ROWS)
    want = ref_ip.run(quick=True)
    out = tmp_path / "i.json"
    try:
        res = bench_run.main(["--smoke", "--device", "cpu", "--only",
                              "install", "--install-json", str(out)])
    finally:
        obs.metrics.disable_live()      # --smoke turned live metrics on
    got = json.loads(out.read_text())
    ref_names = [r.split(",", 1)[0] for r in ref_common.ROWS[n_ref:]]
    names = [r.split(",", 1)[0] for r in common.ROWS[n_port:]]
    # the port's install takes no buffer count: the rows drop ",nb=2"
    assert names == [n.replace(",nb=2", "") for n in ref_names]
    assert set(got) == set(want) | {"metrics", "seed"}
    assert set(got["gate"]) == set(want["gate"])
    assert got["gate"]["parity"] is True
    for k in ("d2h_per_spill_fused", "d2h_per_spill_ref",
              "h2c_hops_batched", "h2c_hops_loop"):
        assert got["gate"][k] == want["gate"][k], k
    assert res["install_path"]["gate"] == got["gate"]
    assert [set(r) for r in got["install"]] == [
        set(r) - {"n_buffers"} for r in want["install"]]
