"""Page pack and install of the port against the reference's Pallas
kernels (interpret mode), byte for byte, on the five cache families of
``tests/test_kernels.py`` plus one tree with a leaf that has no slot axis
and one whose offset is not aligned to its itemsize."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import page_install as P  # noqa: E402

FAMILIES = ["qwen2-0.5b", "rwkv6-1.6b", "qwen2-moe-a2.7b",
            "qwen2-vl-7b", "recurrentgemma-2b"]
CASES = FAMILIES + ["synthetic"]
BATCH = 3


def _synthetic(batch):
    """A "len" counter with no slot axis (merges by max) and a bf16 leaf
    at an odd byte offset (behind a 3-byte int8 leaf)."""
    return {"a_flags": np.zeros((batch, 3), np.int8),
            "b_kv": np.zeros((2, batch, 4, 8), ml_dtypes.bfloat16),
            "c_len": np.zeros((2,), np.int32)}


def _trees(case):
    if case == "synthetic":
        return _synthetic(1), _synthetic(BATCH)
    cfg = reduce_for_smoke(get_config(case))
    return (jax.tree.map(np.asarray, T.init_cache(cfg, 1, 32)),
            jax.tree.map(np.asarray, T.init_cache(cfg, BATCH, 32)))


def _randomize(tree, seed):
    """Random values of each leaf's own dtype (no NaN bit patterns, so the
    reference's bytes are the values' bytes)."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    out = []
    for l in leaves:
        if jnp.issubdtype(l.dtype, jnp.floating):
            out.append(rng.standard_normal(l.shape).astype(np.float32)
                       .astype(l.dtype))
        else:
            out.append(rng.integers(0, 100, l.shape).astype(l.dtype))
    return jax.tree.unflatten(treedef, out)


def _layouts(case):
    single, batch = _trees(case)
    ref = ops.page_layout(single, batch, BATCH)
    port = P.page_layout(interop.tree_to_torch(single),
                         interop.tree_to_torch(batch), BATCH)
    return single, batch, ref, port


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x).reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _ref_pages(single, ref, seeds):
    return np.stack([ops.pack_page_ref(
        ref, jax.tree.leaves(_randomize(single, s))) for s in seeds])


@pytest.mark.parametrize("case", CASES)
def test_page_layout_matches_reference(case):
    _, _, ref, port = _layouts(case)
    assert port.page_bytes == ref.page_bytes
    assert [(s.index, s.offset, s.shape, s.batch_shape, s.dtype,
             s.slot_axis) for s in port.leaves] == \
        [(s.index, s.offset, s.shape, s.batch_shape, s.dtype, s.slot_axis)
         for s in ref.leaves]
    assert port.fallback_indices() == ref.fallback_indices()
    assert {k: [s.index for s in v] for k, v in
            port.kernel_groups().items()} == \
        {k: [s.index for s in v] for k, v in ref.kernel_groups().items()}
    if case == "synthetic":
        assert ref.fallback_indices() == (1, 2)   # misaligned, no slot axis


@pytest.mark.parametrize("case", CASES)
def test_pack_page_matches_reference(case):
    single, _, ref, port = _layouts(case)
    leaves = jax.tree.leaves(_randomize(single, 11))
    want = np.asarray(ops.pack_page(ref, leaves, mode="pallas",
                                    interpret=True))
    np.testing.assert_array_equal(want, ops.pack_page_ref(ref, leaves))
    tleaves = [interop.to_torch(l) for l in leaves]
    np.testing.assert_array_equal(
        P.pack_page_torch(port, tleaves).numpy(), want)
    np.testing.assert_array_equal(P.pack_page(port, tleaves).numpy(), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("form", ["stacked", "entries"])
def test_install_pages_matches_reference(case, form):
    single, batch, ref, port = _layouts(case)
    flat_b = jax.tree.leaves(_randomize(batch, 5))
    pages = _ref_pages(single, ref, (20, 21, 22))
    slots = [2, 0, 1]
    want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                             jnp.asarray(pages), slots, mode="pallas",
                             interpret=True)
    tp = torch.from_numpy(pages)
    if form == "stacked":
        ref_pages, port_pages = jnp.asarray(pages), tp
    else:
        # the TieredStore handoff: a staged group of two (rows swapped)
        # plus one whole page
        ref_pages = [(jnp.asarray(pages[:2]), 1), (jnp.asarray(pages[:2]), 0),
                     (jnp.asarray(pages[2]), None)]
        port_pages = [(tp[:2], 1), (tp[:2], 0), (tp[2], None)]
        slots = [slots[1], slots[0], slots[2]]
        want = ops.install_pages(ref, [jnp.asarray(b) for b in flat_b],
                                 ref_pages, slots, mode="pallas",
                                 interpret=True)
    for fn in (P.install_pages_torch, P.install_pages):
        got = fn(port, [interop.to_torch(b) for b in flat_b], port_pages,
                 slots)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))


@pytest.mark.parametrize("case", CASES)
def test_pack_install_round_trip(case):
    """Pack a slot's leaves, install the page into a zero batch at slot
    1: slot 1 of every slot-axis leaf holds the leaf, the rest stay 0,
    and a no-slot-axis leaf holds the max."""
    single, batch, _, port = _layouts(case)
    leaves = [interop.to_torch(l)
              for l in jax.tree.leaves(_randomize(single, 3))]
    zeros = [interop.to_torch(l) for l in jax.tree.leaves(batch)]
    got = P.install_pages(port, zeros, P.pack_page(port, leaves), [1])
    for sp, g, l in zip(port.leaves, got, leaves):
        if sp.slot_axis is None:
            assert torch.equal(g, torch.maximum(torch.zeros_like(l), l))
            continue
        assert torch.equal(g.narrow(sp.slot_axis, 1, 1), l)
        assert not g.narrow(sp.slot_axis, 0, 1).float().abs().sum()


def test_install_slot_matches_per_leaf_set():
    single, batch, ref, port = _layouts("recurrentgemma-2b")
    flat_b = jax.tree.leaves(_randomize(batch, 7))
    flat_o = jax.tree.leaves(_randomize(single, 8))
    want = ops.install_slot(ref, flat_b, flat_o, 2)
    got = P.install_slot(port, [interop.to_torch(b) for b in flat_b],
                         [interop.to_torch(o) for o in flat_o], 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_bad_arguments_raise():
    single, batch, ref, port = _layouts("qwen2-0.5b")
    leaves = [interop.to_torch(l) for l in jax.tree.leaves(single)]
    flat_b = [interop.to_torch(l) for l in jax.tree.leaves(batch)]
    page = P.pack_page(port, leaves)
    with pytest.raises(NotImplementedError, match="codec"):
        P.install_pages(port, flat_b, page, [0], codec="int8")
    with pytest.raises(ValueError, match="distinct"):
        P.install_pages(port, flat_b, torch.stack([page, page]), [1, 1])
    with pytest.raises(ValueError, match="leaf 0"):
        P.pack_page(port, [leaves[0].float()] + leaves[1:])
    with pytest.raises(ValueError, match="bytes"):
        P.install_pages(port, flat_b, page[:-1], [0])
