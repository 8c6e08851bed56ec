"""The port's cost counter (``repro_torch/launch/hlo.py``) and the
kernels' traced route, on the CPU.

- Collective operand bytes against the reference's HLO parser: the same
  contraction and redistribution, jitted over 8 host devices in the
  reference and run as DTensors over a fake (4, 2) group in the port,
  give the same categories, counts and bytes (each side in a subprocess:
  the reference's device count is fixed at jax's start, the fake group
  is a process group).
- ``Trace``'s memory count by storage lifetime, its bytes accessed and
  its FLOPs, which equal ``FlopCounterMode``'s on a plain step.
- The flash and rg_lru wrappers on meta and fake tensors: the op's one
  output, the kernel route recorded for the backward, the FLOP formulas
  (live (q, k) pairs, the scan's multiply-adds); the real CPU route
  unchanged.
"""
import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import SRC  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import rg_lru as RG  # noqa: E402
from repro_torch.launch import hlo  # noqa: E402

REF_CHILD = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch.hlo import collective_bytes
# jax.make_mesh's Explicit axes fail the reference's sharding (C, A.7)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
put = lambda shape, spec: jax.device_put(jnp.zeros(shape, jnp.float32),
                                         NamedSharding(mesh, spec))
x, w = put((64, 256), P("data", "model")), put((256, 128), P("model", None))
out = lambda spec: NamedSharding(mesh, spec)
text = {
    "matmul": jax.jit(lambda x, w: x @ w, out_shardings=out(P("data", None)))
              .lower(x, w).compile().as_text(),
    "gather": jax.jit(lambda w: w, out_shardings=out(P()))
              .lower(w).compile().as_text(),
}
print(json.dumps({k: collective_bytes(v) for k, v in text.items()}))
"""

PORT_CHILD = r"""
import json
import torch
from repro_torch.launch.dryrun import fake_group, on_meta
from repro_torch.launch.hlo import Trace, collective_bytes
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.sharding import placements

def meta(shape, mesh, spec):
    return on_meta(torch.empty(shape, device="meta"),
                   (mesh, placements(spec, mesh)))

def count(fn):
    tr = Trace()
    with tr:
        fn()
    return collective_bytes(tr)

with fake_group(8):
    mesh = make_dev_mesh(4, 2)
    x = meta((64, 256), mesh, ("data", "model"))
    w = meta((256, 128), mesh, ("model", None))
    print(json.dumps({
        "matmul": count(lambda: (x @ w).redistribute(
            mesh, placements(("data", None), mesh))),
        "gather": count(lambda: w.redistribute(
            mesh, placements((None, None), mesh)))}))
"""


def _child(code: str, env=None) -> dict:
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  OMP_NUM_THREADS="1", **(env or {})),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both_counts():
    return (_child(REF_CHILD, {"JAX_PLATFORMS": "cpu"}), _child(PORT_CHILD))


@pytest.mark.parametrize("case,want", [
    ("matmul", {"all-reduce": {"count": 1, "operand_bytes": 8192.0}}),
    ("gather", {"all-gather": {"count": 1, "operand_bytes": 65536.0}}),
])
def test_collective_bytes_equal_the_reference_parser(both_counts, case, want):
    """x (64, 256) on P("data", "model") @ w (256, 128) on P("model",
    None) out to P("data", None): one all-reduce of the (16, 128) float32
    partial; w gathered to P(): one all-gather of its 65,536-byte
    shard."""
    ref, port = both_counts
    assert ref[case] == want
    assert port[case] == ref[case]


def test_trace_counts_storages_once_from_birth_to_death():
    """A view shares its base's storage and counts once; a storage
    drops out when its last view dies; the peak is the most live at
    once; the arguments never count; the mode keeps no tensor alive."""
    a = torch.empty(1000, device="meta")              # 4000 B argument
    tr = hlo.Trace()
    assert tr.arguments({"a": a, "v": [a[10:]]}) == 4000
    with tr:
        b = a * 2                                     # 4000 B
        v = b[10:]                                    # a view: nothing new
        c = torch.empty(500, dtype=torch.float64, device="meta")  # 4000 B
        alive = weakref.ref(c)
        del b, c
        gc.collect()
        assert tr.live == 4000                        # v keeps b's storage
        d = v + 1                                     # 3960 B
        del v, d
    gc.collect()
    assert alive() is None
    assert tr.peak == 8000 and tr.live == 0 and tr.argument == 4000
    top = tr.live_at_peak(2)
    assert [r["bytes"] for r in top] == [4000, 4000]
    assert {r["op"] for r in top} == {"aten.mul.Tensor",
                                      "aten.empty.memory_format"}


def test_trace_bytes_and_flops():
    """Bytes accessed are every non-view op's inputs and outputs; FLOPs
    are FlopCounterMode's formulas."""
    x = torch.randn(8, 16)
    w = torch.randn(16, 4)
    tr = hlo.Trace()
    with tr:
        y = (x @ w).t()           # mm, then a view
        y.add_(1.0)               # in place: no new storage
    assert hlo.cost_analysis_dict(tr) == {
        "flops": 2.0 * 8 * 16 * 4,
        "bytes accessed": 4.0 * (8 * 16 + 16 * 4 + 8 * 4) + 4.0 * (2 * 32)}
    assert tr.peak == 4 * 8 * 4 and tr.ops == 3 and tr.chars > 0
    assert hlo.total_collective_bytes(tr) == (0, {})


@pytest.mark.parametrize("S,causal,window", [
    (1, True, None), (17, True, None), (17, False, None), (64, True, 16),
    (64, False, 16), (64, True, 64), (64, True, 100), (33, False, 1)])
def test_live_pairs_count_the_mask(S, causal, window):
    i = np.arange(S)[:, None]
    k = np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= k <= i
    if window is not None:
        keep &= k > i - window
    assert FA.live_pairs(S, causal, window) == int(keep.sum())


def _qkv(device, B=2, S=64, H=4, KV=2, dh=16, dtype=torch.bfloat16):
    return [torch.randn(B, S, n, dh).to(dtype).to(device) for n in (H, KV, KV)]


@pytest.mark.parametrize("window", [None, 24])
def test_flash_on_meta_is_the_op_with_the_kernels_cost(window):
    """On meta tensors the wrapper calls the op once: one output of q's
    shape (what ``_launch`` allocates), FLOPs 4 B H dh over the live
    pairs, and under autograd the backward the card runs (its scores
    from the inputs, not the CPU forward's tiles)."""
    q, k, v = _qkv("meta")
    tr = hlo.Trace()
    tr.arguments(q, k, v)
    with tr:
        o = FA.flash_attention(q, k, v, window=window, chunk=16)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_contiguous()
    assert tr.ops == 1 and tr.peak == o.numel() * 2
    assert tr.flops == 4 * 2 * 4 * 16 * FA.live_pairs(64, True, window)
    with FlopCounterMode(display=False) as fc:
        FA.flash_attention(q, k, v, window=window, chunk=16)
    assert fc.get_total_flops() == tr.flops

    seen = []
    bwd = FA.flash_attention_bwd

    def spy(*a, **kw):
        seen.append(kw["chunked_scores"])
        return bwd(*a, **kw)
    qg, kg, vg = (t.requires_grad_() for t in _qkv("meta"))
    FA.flash_attention_bwd = spy
    try:
        grads = torch.autograd.grad(
            FA.flash_attention(qg, kg, vg, window=window, chunk=16).sum(),
            (qg, kg, vg))
    finally:
        FA.flash_attention_bwd = bwd
    assert seen == [False]
    assert [g.shape for g in grads] == [qg.shape, kg.shape, vg.shape]


def test_flash_on_fake_tensors_takes_the_op():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    with FakeTensorMode():
        q, k, v = _qkv("cpu")
        o = FA.flash_attention(q, k, v, chunk=16)
    assert isinstance(o, FakeTensor) and o.shape == q.shape
    assert FA._plain_route(q) is False


def test_flash_real_cpu_route_is_unchanged_under_a_mode():
    """Real CPU tensors: the plain version, with or without a counting
    mode on the stack (then through the op), bit for bit; the backward
    rebuilds the CPU forward's tiles."""
    torch.manual_seed(0)
    q, k, v = _qkv("cpu", dtype=torch.float32)
    want = FA.attention_chunked(q, k, v, chunk_q=16, chunk_k=16)
    assert torch.equal(FA.flash_attention(q, k, v, chunk=16), want)
    with FlopCounterMode(display=False) as fc:
        got = FA.flash_attention(q, k, v, chunk=16)
    assert torch.equal(got, want)
    assert fc.get_total_flops() == 4 * 2 * 4 * 16 * FA.live_pairs(64, True,
                                                                  None)
    assert FA._plain_route(q) is True


def test_rg_lru_on_meta_is_the_op_and_cpu_is_unchanged():
    a = torch.rand(2, 10, 8)
    b = torch.randn(2, 10, 8)
    a_m, b_m = a.to("meta"), b.to("meta")
    tr = hlo.Trace()
    with tr:
        h = RG.rg_lru_scan(a_m, b_m)
    assert h.shape == a.shape and h.device.type == "meta"
    assert tr.ops == 1 and tr.flops == 2 * 2 * 10 * 8
    assert tr.peak == a.numel() * 4
    want = RG.rg_lru_scan_torch(a, b)
    with FlopCounterMode(display=False) as fc:
        assert torch.equal(RG.rg_lru_scan(a, b), want)
    assert fc.get_total_flops() == 2 * 2 * 10 * 8
    assert torch.equal(RG.rg_lru_scan(a, b), want)
    # the backward on meta: the reversed scan through the op again
    am, bm = (t.to("meta").requires_grad_() for t in (a, b))
    tr = hlo.Trace()
    with tr:
        torch.autograd.grad(RG.rg_lru_scan(am, bm).sum(), (am, bm))
    assert tr.flops == 2 * (2 * 2 * 10 * 8)


def test_untraced_calls_do_not_touch_the_dispatcher():
    """Off meta and fake tensors and with no mode on the stack, the
    wrappers take their direct routes (the card's has no dispatcher
    detour)."""
    from repro_torch.device import traced
    q = torch.randn(1, 4, 2, 16)
    assert not traced(q)
    assert traced(q.to("meta"))
    with FlopCounterMode(display=False):
        assert traced(q)


def test_flash_host_timer_checks_and_times_the_plain_version(capsys,
                                                            monkeypatch):
    """``benchmarks/flash_host.py`` (the wrapper's host time a call, for
    any checkout) on the CPU: the plain version, checked, host time
    only (2 calls a round, to spare the other test workers the CPU)."""
    from repro_torch.benchmarks import flash_host
    monkeypatch.setattr(flash_host, "CALLS", 2)
    rows = flash_host.main(["--device", "cpu", "--rounds", "2"])
    assert [r["shape"] for r in rows] == [list(s) for s in flash_host.SHAPES]
    assert all(r["kernel_ms"] is None and r["host_us_per_call"] > 0
               for r in rows)
    assert capsys.readouterr().out.count("[flash-host]") == 2


def test_logsumexp_counts_its_kernels_temporary():
    """``torch.logsumexp``'s kernel subtracts the max into a temporary of
    its input's size, which no dispatch shows: the trace counts it for
    that op alone, then the (4,) output."""
    x = torch.empty(4, 1000, device="meta")
    tr = hlo.Trace()
    tr.arguments(x)
    with tr:
        y = torch.logsumexp(x, dim=-1)
    assert tr.peak == 4 * 1000 * 4 and tr.live == y.numel() * 4
    assert tr.live_at_peak(1)[0]["op"] == "aten.logsumexp.default"


@pytest.mark.parametrize("op", ["gather", "index", "index_select"])
def test_backward_scatter_counts_one_gradient_buffer(op):
    """Under a dispatch mode the backward of ``gather``, indexing and
    ``index_select`` scatters into a copy of a fresh zero buffer, where
    the step run with no mode scatters into the buffer itself: the
    trace counts one input-sized gradient buffer, as the card holds.
    The same out-of-place scatter outside a backward counts both."""
    x = torch.empty(4, 1000, device="meta", requires_grad=True)
    i = torch.zeros(4, 3, dtype=torch.long, device="meta")
    t = torch.zeros(6, dtype=torch.long, device="meta")
    tr = hlo.Trace()
    tr.arguments(x, i, t)
    with tr:
        y = {"gather": lambda: torch.gather(x, -1, i),
             "index": lambda: x[t],
             "index_select": lambda: torch.index_select(x, 0, t)}[op]()
        y.sum().backward()
    grad = 4 * 1000 * 4
    assert x.grad.shape == x.shape
    assert [r["bytes"] for r in tr.live_at_peak(8)].count(grad) == 1
    assert tr.peak == grad + y.numel() * 4 + 2 * 4   # + the sum, its grad
    tr = hlo.Trace()
    tr.arguments(x, i)
    with tr:
        torch.zeros_like(x).scatter_add(-1, i, torch.ones(4, 3, device="meta"))
    assert tr.peak == 2 * grad + 4 * 3 * 4
