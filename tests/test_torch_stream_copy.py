"""The port's stream copy against the reference's Pallas kernel
(interpret mode) on ``tests/test_kernels.py``'s grid, its byte identity,
its argument checks, its CTA layout rule, the kernel facade, and the
Fig-8 sweep twin on the CPU."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import vmem_stream as ref_sweep  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import vmem_stream  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import page_install as PI  # noqa: E402
from repro_torch.kernels import rg_lru as RG  # noqa: E402
from repro_torch.kernels import streamcopy as SC  # noqa: E402

GRID = [(64, 128, 8, 1), (64, 128, 8, 2), (256, 256, 32, 4),
        (128, 128, 128, 2), (64, 256, 16, 3)]


def _input(R, C, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(0, 1000, (R, C)).astype(np.int32)
    return rng.standard_normal((R, C)).astype(np.float32).astype(
        jnp.dtype(dtype))


@pytest.mark.parametrize("R,C,br,nb", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_stream_copy_matches_reference(R, C, br, nb, dtype):
    x = _input(R, C, dtype, seed=R + C + br + nb)
    want = np.asarray(ref_ops.stream_copy(jnp.asarray(x), block_rows=br,
                                          n_buffers=nb, interpret=True))
    got = ops.stream_copy(interop.to_torch(x), block_rows=br, n_buffers=nb)
    assert interop.dtype_name(got) == dtype and tuple(got.shape) == (R, C)
    np.testing.assert_array_equal(interop.to_numpy(got).view(np.uint8),
                                  want.view(np.uint8))


@pytest.mark.parametrize("dtype,bits", [
    ("float32", (0x80000000, 0x7FC00123, 0xFF800001, 0x7F800000)),
    ("bfloat16", (0x8000, 0x7FBE, 0xFFC1, 0x7F80)),
])
def test_stream_copy_keeps_negative_zero_and_nan_payloads(dtype, bits):
    """The reference's oracle (``x + zeros``) turns -0.0 into +0.0; the
    copy itself must keep every byte."""
    x = _input(64, 128, dtype, seed=5)
    word = np.uint32 if dtype == "float32" else np.uint16
    x.view(word).reshape(-1)[:len(bits)] = bits
    xt = interop.to_torch(x)
    got = SC.stream_copy(xt, block_rows=16, n_buffers=2)
    np.testing.assert_array_equal(interop.to_numpy(got).view(np.uint8),
                                  x.view(np.uint8))
    assert got.data_ptr() != xt.data_ptr()


@pytest.mark.parametrize("shape,br,nb,match", [
    ((60, 128), 8, 2, "multiple of block_rows"),
    ((64, 128), 8, 0, "n_buffers"),
    ((64, 128), 0, 1, "multiple of block_rows"),
    ((64,), 8, 1, "2-D"),
])
def test_bad_arguments_raise_value_error(shape, br, nb, match):
    with pytest.raises(ValueError, match=match):
        SC.stream_copy(torch.zeros(shape), block_rows=br, n_buffers=nb)


@pytest.mark.parametrize("block_bytes,nb,n_sms,want", [
    (256 * 1024, 2, 132, (256, 1024)),     # Fig-8's largest block
    (16 * 1024, 1, 132, (128, 128)),       # a slice is one line at least
    (4 << 20, 4, 132, (132, 31872)),
    (64 << 20, 2, 132, (579, 115968)),     # the stages force P past SMs
    (16, 3, 132, (1, 128)),
])
def test_plan_fits_every_stage_into_shared_memory(block_bytes, nb, n_sms,
                                                  want):
    n, slice_bytes = SC.plan(block_bytes, nb, n_sms)
    assert (n, slice_bytes) == want
    assert slice_bytes % SC.ALIGN == 0
    assert (n - 1) * slice_bytes < block_bytes <= n * slice_bytes
    assert SC._header_bytes(nb) + nb * slice_bytes <= SC.MAX_SMEM


@pytest.mark.parametrize("block_bytes,nb", [(24, 1), (0, 1),
                                             (1 << 20, 20000)])
def test_plan_raises_where_no_layout_fits(block_bytes, nb):
    with pytest.raises(ValueError):
        SC.plan(block_bytes, nb, 132)


def test_every_fig8_cell_fits():
    for br in vmem_stream.BLOCK_ROWS:
        for nb in vmem_stream.BUFFERS:
            n, s = SC.plan(br * vmem_stream.COLS * 4, nb, 132)
            assert SC._header_bytes(nb) + nb * s <= SC.MAX_SMEM


@pytest.mark.parametrize("block_bytes", [
    16, 48, 4096, 16 * 1024, 64 * 1024, 256 * 1024, 1 << 20, (1 << 20) + 16,
    4 << 20, 3 * 1000 * 16])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_plan_slices_start_on_lines_and_cover_each_block(block_bytes, nb):
    """Slice i is [i s, min((i + 1) s, block)): every one starts on a
    128-byte line and holds bytes, and together they are the block."""
    n, s = SC.plan(block_bytes, nb, 132)
    assert s % SC.LINE == 0
    starts = [i * s for i in range(n)]
    ends = [min(a + s, block_bytes) for a in starts]
    assert all(a % SC.LINE == 0 and e > a for a, e in zip(starts, ends))
    assert starts[0] == 0 and ends[-1] == block_bytes
    assert all(e == a for e, a in zip(ends, starts[1:]))
    assert all(e - a == s for a, e in zip(starts[:-1], ends[:-1]))
    assert SC._header_bytes(nb) + nb * s <= SC.MAX_SMEM


@pytest.mark.parametrize("block_bytes,nb,want", [
    (4 << 20, 1, 521), (4 << 20, 2, 263), (4 << 20, 4, 132),
    (1 << 20, 2, 256), (16 * 1024, 1, 128),
])
def test_plan_puts_about_four_stages_on_each_sm(block_bytes, nb, want):
    """The 256 MiB rows of chip_smoke.py: four CTAs an SM with one
    buffer, two with two, one with four; never past one line a slice."""
    n, s = SC.plan(block_bytes, nb, 132)
    assert n == want
    lines = -(-block_bytes // SC.LINE)
    target = min(lines, 132 * max(1, SC.STAGES_PER_SM // nb))
    # slices rounded up to whole lines take a few CTAs off the target
    assert 0.95 * target <= n <= target


def test_launch_checks_slices_on_lines():
    cu = (pathlib.Path(SC.__file__).resolve().parent.parent / "csrc" /
          "stream_copy.cu").read_text()
    assert f"constexpr int kLine = {SC.LINE};" in cu
    assert "slice_bytes % kLine" in cu


def test_sm_count_is_read_once_per_device(monkeypatch):
    from repro_torch import device as D
    calls = []

    class Props:
        multi_processor_count = 132

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    D._sm_count.cache_clear()
    try:
        dev = torch.device("cuda", 3)
        assert D.sm_count(dev) == 132 and D.sm_count(dev) == 132
        assert calls == [3]
    finally:
        D._sm_count.cache_clear()


def test_facade_reexports_the_kernel_modules():
    assert ops.stream_copy is SC.stream_copy
    assert ops.stream_copy_ref is SC.stream_copy_torch
    assert ops.flash_attention is FA.flash_attention
    assert ops.attention_ref is FA.attention_chunked
    assert ops.rg_lru_scan is RG.rg_lru_scan
    assert ops.rg_lru_scan_ref is RG.rg_lru_scan_torch
    assert ops.pack_page is PI.pack_page
    assert ops.pack_page_ref is PI.pack_page_torch
    assert ops.install_pages is PI.install_pages
    assert ops.install_pages_ref is PI.install_pages_torch
    assert ops.install_slot is PI.install_slot
    assert ops.page_layout is PI.page_layout


def test_cpu_copy_does_not_count_launches():
    before = SC.stream_copy.launches
    SC.stream_copy(torch.zeros(16, 16), block_rows=8)
    assert SC.stream_copy.launches == before


def test_vmem_stream_quick_on_cpu_prints_reference_rows(capsys):
    rows = vmem_stream.main(["--quick", "--device", "cpu"])
    want = [f"fig8_vmem_block{br}x{ref_sweep.COLS}_buf{nb}"
            for br in ref_sweep.BLOCK_ROWS[:2]
            for nb in ref_sweep.BUFFERS[:2]]
    assert [r["name"] for r in rows] == want
    out = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in out] == want
    for line in out:
        assert "h100_copy=not_measured" in line and "paper_bram=" in line
    assert (vmem_stream.BLOCK_ROWS, vmem_stream.BUFFERS,
            vmem_stream.COLS) == (ref_sweep.BLOCK_ROWS, ref_sweep.BUFFERS,
                                  ref_sweep.COLS)


def test_vmem_stream_paper_model_matches_reference():
    from repro.core.analytical import bandwidth_gbps, paper_pcie_bram
    from repro.core.channels import Direction
    rows = vmem_stream.run(quick=True, device="cpu")
    for r in rows:
        want = bandwidth_gbps(paper_pcie_bram(), r["block_bytes"],
                              r["n_buffers"], Direction.C2H)
        assert r["paper_bram_gbps"] == pytest.approx(want, rel=1e-12)


def test_vmem_stream_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        vmem_stream.main(["--quick"])

