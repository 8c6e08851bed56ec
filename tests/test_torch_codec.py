"""KV capacity multipliers of the port against the reference
(``tests/test_kv_capacity.py``'s cases): the int8 quantizer, page codecs
(bytes equal to the reference's numpy encode and decode, device decode
equal to numpy decode, NaN bits pinned), the tiered store's codec,
logical-vs-physical accounting and prefix sharing, and
``install_pages(codec=...)`` equal byte for byte to the reference's
``install_pages(mode="ref", codec=...)``."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import quant as ref_quant  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.rmem import TieredStore as RefStore  # noqa: E402
from repro.rmem import codec as ref_codecs  # noqa: E402
from repro_torch import interop, quant  # noqa: E402
from repro_torch.kernels import page_install as PI  # noqa: E402
from repro_torch.rmem import codec as codecs  # noqa: E402
from repro_torch.rmem.store import TieredStore  # noqa: E402

FAMILIES = ["qwen2-0.5b", "rwkv6-1.6b", "qwen2-moe-a2.7b",
            "qwen2-vl-7b", "recurrentgemma-2b"]
BATCH = 3


def _f32_page(n=256, seed=2):
    return np.random.default_rng(seed).standard_normal(n) \
        .astype(np.float32)


def _store(n_pages=4, hot=2, **kw):
    return TieredStore(n_pages, (64,), dtype="float32", n_hot_slots=hot,
                       path="xdma", device="cpu", **kw)


# ---------------------------------------------------------------------------
# quant: torch and numpy twins, bit for bit with the reference
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(1)
    return {
        "zeros": np.zeros(64, np.float32),
        "nonfinite": np.array([1.0, np.nan, np.inf, -np.inf, -2.0],
                              np.float32),
        "normal": rng.standard_normal(256).astype(np.float32),
        "ties": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32),
        "huge": np.array([3e38, -3e38, 1e-40, 7.0], np.float32),
    }


class TestQuant:
    @pytest.mark.parametrize("case", sorted(_quant_inputs()))
    def test_twins_equal_the_reference_bitwise(self, case):
        x = _quant_inputs()[case]
        want_q, want_s = ref_quant.np_quantize_int8(x)
        jq, js = ref_quant.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(jq), want_q)
        q, s = quant.np_quantize_int8(x)
        np.testing.assert_array_equal(q, want_q)
        assert np.float32(s).view(np.uint32) == \
            np.float32(want_s).view(np.uint32)
        tq, ts = quant.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), want_q)
        assert ts.numpy().view(np.uint32) == \
            np.float32(want_s).view(np.uint32)
        want_d = ref_quant.np_dequantize_int8(want_q, want_s)
        np.testing.assert_array_equal(
            quant.np_dequantize_int8(q, s).view(np.uint32),
            want_d.view(np.uint32))
        np.testing.assert_array_equal(
            quant.dequantize_int8(tq, ts).numpy().view(np.uint32),
            want_d.view(np.uint32))

    def test_all_zero_tensor_has_finite_scale_and_exact_roundtrip(self):
        x = torch.zeros(64)
        q, s = quant.quantize_int8(x)
        assert float(s) == np.float32(1.0 / 127.0)
        assert torch.equal(quant.dequantize_int8(q, s), x)

    def test_nonfinite_values_dequantize_finite(self):
        x = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
        q, s = quant.quantize_int8(x)
        assert bool(torch.isfinite(s)) and \
            bool(torch.isfinite(quant.dequantize_int8(q, s)).all())

    def test_roundtrip_error_bounded_by_scale(self):
        x = torch.from_numpy(_f32_page(512, 0))
        q, s = quant.quantize_int8(x)
        err = float((x - quant.dequantize_int8(q, s)).abs().max())
        assert err <= float(x.abs().max()) / 127.0

    def test_dequantize_to_bf16_matches_reference(self):
        x = _f32_page(128, 3)
        q, s = ref_quant.np_quantize_int8(x)
        want = np.asarray(ref_quant.dequantize_int8(
            jnp.asarray(q), jnp.float32(s), jnp.bfloat16))
        got = quant.dequantize_int8(torch.from_numpy(q),
                                    torch.tensor(s), torch.bfloat16)
        np.testing.assert_array_equal(interop.to_numpy(got),
                                      want.view(np.uint16))


# ---------------------------------------------------------------------------
# PageCodec: bytes equal to the reference's, device decode parity
# ---------------------------------------------------------------------------

def _mixed_page(seed=4):
    """f32 (with NaN payloads, ±Inf, -0.0), bf16 (with a NaN payload),
    f16 and int32 segments."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(64).astype(np.float32)
    f32.view(np.uint32)[:5] = (0x7FC00000, 0xFF800001, 0x7F800000,
                               0x80000000, 0x7FBFFFFF)
    bf = rng.standard_normal(32).astype(ml_dtypes.bfloat16)
    bf.view(np.uint16)[:2] = (0x7FBE, 0xFFC1)
    f16 = rng.standard_normal(16).astype(np.float16)
    i32 = rng.integers(0, 100, 8).astype(np.int32)
    parts = (f32, bf, f16, i32)
    segs, off = [], 0
    for a in parts:
        segs.append((off, a.nbytes, a.dtype.name))
        off += a.nbytes
    return np.concatenate([a.view(np.uint8) for a in parts]), segs


class TestPageCodec:
    def test_none_is_no_codec(self):
        assert codecs.make_codec(None, 64) is None
        assert codecs.make_codec("none", 64) is None
        with pytest.raises(ValueError):
            codecs.make_codec("zstd", 64)

    @pytest.mark.parametrize("name", ["bf16", "int8"])
    @pytest.mark.parametrize("seed", [4, 5])
    def test_encode_decode_bytes_equal_the_reference(self, name, seed):
        page, segs = _mixed_page(seed)
        rc = ref_codecs.make_codec(name, page.nbytes,
                                   [ref_codecs.Segment(*s) for s in segs])
        pc = codecs.make_codec(name, page.nbytes,
                               [codecs.Segment(*s) for s in segs])
        assert [(s.kind, s.enc_offset, s.enc_nbytes) for s in pc.segs] == \
            [(s.kind, s.enc_offset, s.enc_nbytes) for s in rc.segs]
        enc = rc.encode(page)
        np.testing.assert_array_equal(pc.encode(page), enc)
        np.testing.assert_array_equal(pc.decode(enc), rc.decode(enc))

    @pytest.mark.parametrize("name", ["bf16", "int8"])
    def test_device_decode_equals_numpy_decode(self, name):
        page, segs = _mixed_page()
        c = codecs.make_codec(name, page.nbytes,
                              [codecs.Segment(*s) for s in segs])
        enc = np.stack([c.encode(page), c.encode(page[::-1])])
        got = c.decode_row(torch.from_numpy(enc))
        for g in range(2):
            np.testing.assert_array_equal(got[g].numpy(), c.decode(enc[g]))
        np.testing.assert_array_equal(
            c.decode_row(torch.from_numpy(enc[1])).numpy(),
            c.decode(enc[1]))

    def test_nan_bits_of_the_bf16_narrowing_are_pinned(self):
        """The port narrows float32 to bf16 on the bits (no ml_dtypes):
        round to nearest even, NaN -> sign | 0x7fc0, as ml_dtypes."""
        bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FBFFFFF,
                         0xFF80FFFF, 0x7F800000, 0xFF800000, 0x3F808000,
                         0x3F818000, 0x7F7FFFFF, 0x00000001, 0x80000000,
                         0x3F80FFFF], np.uint32)
        f = bits.view(np.float32)
        with np.errstate(invalid="ignore"):
            want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(codecs.f32_to_bf16_bits(f), want)
        np.testing.assert_array_equal(
            codecs.f32_to_bf16_bits(f)[:5],
            [0x7FC0, 0xFFC0, 0x7FC0, 0x7FC0, 0xFFC0])
        u = np.array([0x7FBE, 0xFFC1, 0x7F81, 0x0001, 0x8000], np.uint16)
        np.testing.assert_array_equal(
            codecs.bf16_bits_to_f32(u).view(np.uint32),
            u.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))

    def test_bf16_on_bf16_segments_is_lossless(self):
        x = np.random.default_rng(3).standard_normal(128) \
            .astype(ml_dtypes.bfloat16).view(np.uint8)
        c = codecs.make_codec("bf16", x.nbytes,
                              [codecs.Segment(0, x.nbytes, "bfloat16")])
        assert c.encoded_bytes == x.nbytes
        np.testing.assert_array_equal(c.decode(c.encode(x)), x)

    def test_int8_bounded_error_and_stable_requant(self):
        x = _f32_page()
        c = codecs.make_codec("int8", x.nbytes, dtype="float32")
        assert c.encoded_bytes == 4 + x.size
        enc = c.encode(x)
        d1 = c.decode(enc).view(np.float32)
        assert np.max(np.abs(x - d1)) <= np.max(np.abs(x)) / 127.0
        enc2 = c.encode(d1)
        np.testing.assert_array_equal(enc2[4:], enc[4:])

    def test_segments_must_tile_the_page(self):
        with pytest.raises(ValueError, match="contiguously"):
            codecs.make_codec("int8", 16, [codecs.Segment(4, 12, "float32")])
        with pytest.raises(ValueError, match="cover"):
            codecs.make_codec("int8", 16, [codecs.Segment(0, 8, "float32")])
        with pytest.raises(ValueError, match="whole"):
            codecs.make_codec("int8", 6, [codecs.Segment(0, 6, "float32")])

    def test_delta_roundtrip_equals_the_reference(self):
        rng = np.random.default_rng(5)
        base = rng.integers(0, 256, 1000, np.uint8)
        new = base.copy()
        new[130:140] ^= 0xFF
        delta = codecs.delta_encode(base, new)
        np.testing.assert_array_equal(delta,
                                      ref_codecs.delta_encode(base, new))
        assert delta.nbytes < new.nbytes
        np.testing.assert_array_equal(codecs.delta_apply(base, delta), new)
        empty = codecs.delta_encode(base, base)
        np.testing.assert_array_equal(codecs.delta_apply(base, empty), base)

    def test_row_decoder_gives_the_typed_page(self):
        x = _f32_page(64, 9)
        c = codecs.make_codec("int8", x.nbytes, dtype="float32")
        group = torch.from_numpy(np.stack([c.encode(x[::-1].copy()),
                                           c.encode(x)]))
        got = codecs.row_decoder(c, "float32", (8, 8))(group, 1)
        assert got.dtype == torch.float32 and tuple(got.shape) == (8, 8)
        np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint8),
                                      c.decode(c.encode(x)))


# ---------------------------------------------------------------------------
# TieredStore: codec at the tier boundary, logical-vs-physical stats
# ---------------------------------------------------------------------------

class TestStoreCodec:
    def test_physical_page_bytes_and_capacity_sizing(self):
        with _store(codec="int8") as st:
            assert st.page_bytes == 256
            assert st.phys_page_bytes == 4 + 64
            assert st.backend.page_bytes == st.phys_page_bytes

    def test_bf16_codec_on_bf16_segments_roundtrips_bit_exact(self):
        vals = {p: np.random.default_rng(p).standard_normal(32)
                .astype(ml_dtypes.bfloat16).view(np.uint8) for p in range(3)}
        with TieredStore(3, (64,), dtype="uint8", n_hot_slots=3,
                         codec="bf16",
                         codec_segments=[codecs.Segment(0, 64, "bfloat16")],
                         path="xdma", device="cpu") as st:
            assert st.phys_page_bytes == st.page_bytes
            for p, v in vals.items():
                st.write_page(p, v)
                st.release(p)
            got = st.ensure([0, 1, 2])
            for p, v in vals.items():
                np.testing.assert_array_equal(got[p].numpy(), v)

    def test_int8_codec_roundtrip_equals_codec_decode(self):
        v = _f32_page(64, seed=6)
        with _store(n_pages=2, codec="int8") as st:
            st.write_page(0, v)
            st.release(0)
            got = st.ensure([0])[0].numpy()
            np.testing.assert_array_equal(
                got.view(np.uint8), st.codec.decode(st.codec.encode(v)))

    def test_ensure_packed_hands_back_encoded_rows(self):
        vals = {p: _f32_page(64, seed=10 + p) for p in range(3)}
        with _store(n_pages=3, hot=3, codec="int8") as st:
            for p, v in vals.items():
                st.write_page(p, v)
                st.release(p)
            packed = st.ensure_packed([0, 1, 2])
            for p, (buf, row) in packed.items():
                assert st.staged_encoded(p)
                raw = buf if row is None else buf[row]
                np.testing.assert_array_equal(
                    raw.numpy()[:st.phys_page_bytes],
                    st.codec.encode(vals[p]))
            got = st.ensure([0])[0]
            assert not st.staged_encoded(0)
            np.testing.assert_array_equal(
                got.numpy().view(np.uint8),
                st.codec.decode(st.codec.encode(vals[0])))
            assert st.stats()["h2c_bytes"] == 3 * st.phys_page_bytes

    def test_stats_export_logical_physical_and_ratio(self):
        with _store(codec="int8") as st:
            for p in range(4):
                st.write_page(p, _f32_page(64, seed=p))
            for p in list(st.slot_of_page):
                st.release(p)
            kv = st.stats()
            assert kv["codec"] == "int8"
            assert kv["cold_bytes_logical"] == 4 * 256
            assert kv["cold_bytes_physical"] == 4 * 68
            assert kv["compression_ratio"] == pytest.approx(256 / 68)
            assert kv["spill_bytes_logical"] >= 4 * 256
            assert kv["spill_bytes_physical"] >= 4 * 68

    @pytest.mark.parametrize("codec", [None, "int8"])
    def test_eviction_counters_equal_the_reference(self, codec):
        """Misses on a 2-slot store evict; every eviction is clean (no
        page was written on the device), in both packages."""
        vals = {p: _f32_page(64, seed=40 + p) for p in range(4)}
        with _store(codec=codec) as st, \
                RefStore(4, (64,), dtype="float32", n_hot_slots=2,
                         codec=codec) as ref:
            for p, v in vals.items():
                st.write_page(p, v)
                ref.write_page(p, v)
            for pages in ([0], [1], [2], [3], [0, 1], [2]):
                got = st.ensure(pages)
                want = ref.ensure(pages)
                for p in pages:
                    np.testing.assert_array_equal(got[p].numpy(),
                                                  np.asarray(want[p]))
            got, want = st.stats(), ref.stats()
            assert got["evictions"] > 0
            for key in ("evictions", "clean_evictions", "dirty_evictions",
                        "writeback_bytes_skipped", "c2h_bytes",
                        "h2c_bytes"):
                assert got[key] == want[key], key
            assert got["dirty_evictions"] == 0 and got["c2h_bytes"] == 0
            assert got["writeback_bytes_skipped"] == \
                got["evictions"] * st.page_bytes

    def test_capacity_budget_tracks_physical_bytes(self):
        with _store(codec="int8", capacity_bytes=3 * 68) as st:
            assert st.free_cold_bytes() == 3 * 68
            for p in range(2):
                st.write_page(p, _f32_page(64, seed=p))
            assert st.free_cold_bytes() == 68
            st.discard_cold(0)
            assert st.free_cold_bytes() == 2 * 68
        with _store() as st:
            assert st.free_cold_bytes() is None


# ---------------------------------------------------------------------------
# cross-request prefix sharing: dedup, COW, invalidation, zombies
# ---------------------------------------------------------------------------

class TestPrefixSharing:
    def _store(self, codec=None):
        return TieredStore(8, (64,), dtype="float32", n_hot_slots=2,
                           codec=codec, shared_pool=[6, 7], path="xdma",
                           device="cpu")

    def test_dedup_stores_fraction_and_reconstructs_exactly(self):
        base_val = _f32_page(64, seed=20)
        with self._store() as st:
            r0 = st.store_dedup(0, base_val, key=b"sys")
            assert st.shared_misses == 1
            v1 = base_val.copy()
            v1[0] += 1.0
            r1 = st.store_dedup(1, v1, key=b"sys")
            assert st.shared_hits == 1
            assert r1 < 0.5 and r0 < 0.5
            kv = st.stats()
            assert kv["shared_pages"] == 1 and kv["dedup_bytes_saved"] > 0
            got = st.ensure([0, 1])
            np.testing.assert_array_equal(got[0].numpy(), base_val)
            np.testing.assert_array_equal(got[1].numpy(), v1)

    @pytest.mark.parametrize("codec", [None, "bf16", "int8"])
    def test_dedup_accounting_equals_the_reference(self, codec):
        vals = [_f32_page(64, seed=30)]
        for k in range(3):
            v = vals[0].copy()
            v[k * 20:k * 20 + 3] += 1.0
            vals.append(v)
        keys = [b"a", b"a", b"b", b"a"]
        with self._store(codec) as st, \
                RefStore(8, (64,), dtype="float32", n_hot_slots=2,
                         codec=codec, shared_pool=[6, 7]) as ref:
            for p, (v, k) in enumerate(zip(vals, keys)):
                assert st.store_dedup(p, v, key=k) == \
                    ref.store_dedup(p, v, key=k)
            st.write_page(1, vals[2])
            ref.write_page(1, vals[2])
            got, want = st.stats(), ref.stats()
            for key in ("cold_bytes_logical", "cold_bytes_physical",
                        "spill_bytes_logical", "spill_bytes_physical",
                        "shared_pages", "shared_hits", "shared_misses",
                        "cow_copies", "dedup_bytes_saved", "codec",
                        "phys_page_bytes"):
                assert got[key] == want[key], key
            for p in range(4):
                st.release(p)
                np.testing.assert_array_equal(
                    st.ensure([p])[p].numpy(),
                    np.asarray(ref.ensure([p])[p]))

    def test_dedup_under_int8_codec_matches_standalone_decode(self):
        v = _f32_page(64, seed=21)
        with self._store(codec="int8") as st:
            st.store_dedup(0, v, key=b"sys")
            got = st.ensure([0])[0].numpy()
            np.testing.assert_array_equal(
                got.view(np.uint8), st.codec.decode(st.codec.encode(v)))

    def test_cow_on_divergence(self):
        v = _f32_page(64, seed=22)
        with self._store() as st:
            st.store_dedup(0, v, key=b"sys")
            assert st.cow_copies == 0
            st.write_page(0, _f32_page(64, seed=23))
            st.release(0)
            assert st.cow_copies == 1
            np.testing.assert_array_equal(st.ensure([0])[0].numpy(),
                                          _f32_page(64, seed=23))

    def test_invalidate_with_live_refs_leaves_a_zombie(self):
        v = _f32_page(64, seed=24)
        with TieredStore(8, (64,), dtype="float32", n_hot_slots=2,
                         shared_pool=[7], path="xdma", device="cpu") as st:
            st.store_dedup(0, v, key=b"old-epoch")
            st.store_dedup(1, v, key=b"old-epoch")
            st.invalidate_shared(b"old-epoch")
            assert st.lookup_shared(b"old-epoch") is None
            assert st.stats()["shared_pages"] == 0
            # the zombie base still serves its deltas
            np.testing.assert_array_equal(st.ensure([1])[1].numpy(), v)
            assert st.publish_shared(b"new", v) is None
            st.discard_cold(0)
            assert st.publish_shared(b"new", v) is None
            st.discard_cold(1)          # the last ref drains the zombie
            assert st.publish_shared(b"new", v) == 7

    def test_base_pool_recycles_lru_unreferenced(self):
        v = _f32_page(64, seed=25)
        with TieredStore(8, (64,), dtype="float32", n_hot_slots=2,
                         shared_pool=[7], path="xdma", device="cpu") as st:
            assert st.publish_shared(b"a", v) == 7
            assert st.publish_shared(b"b", v) == 7
            assert st.shared_evictions == 1
            assert st.lookup_shared(b"a") is None
            assert st.lookup_shared(b"b") == 7

    def test_discard_cold_refuses_shared_bases(self):
        with TieredStore(8, (64,), dtype="float32", n_hot_slots=2,
                         shared_pool=[7], path="xdma", device="cpu") as st:
            st.publish_shared(b"k", _f32_page(64, seed=26))
            with pytest.raises(ValueError, match="shared base"):
                st.discard_cold(7)
            with pytest.raises(ValueError, match="shared read-only base"):
                st.write_page(7, _f32_page(64, seed=27))


# ---------------------------------------------------------------------------
# install_pages(codec=...) against the reference's mode="ref"
# ---------------------------------------------------------------------------

def _cache_trees(arch, dtype=None, max_len=32):
    cfg = reduce_for_smoke(get_config(arch))
    if dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return (jax.tree.map(np.asarray, RT.init_cache(cfg, 1, max_len)),
            jax.tree.map(np.asarray, RT.init_cache(cfg, BATCH, max_len)))


def _randomize(tree, seed):
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


def _codecs(ref_layout, port_layout, name):
    rc = ref_codecs.make_codec(name, ref_layout.page_bytes, [
        ref_codecs.Segment(sp.offset, sp.nbytes, sp.dtype)
        for sp in ref_layout.leaves if sp.nbytes])
    pc = codecs.make_codec(name, port_layout.page_bytes, [
        codecs.Segment(sp.offset, sp.nbytes, sp.dtype)
        for sp in port_layout.leaves if sp.nbytes])
    return rc, pc


class TestFusedInstallCodec:
    @pytest.mark.parametrize("arch", FAMILIES)
    @pytest.mark.parametrize("name", ["int8", "bf16"])
    @pytest.mark.parametrize("dtype", [None, "float32"])
    def test_install_encoded_pages_equals_reference(self, arch, name,
                                                    dtype):
        single, batch = _cache_trees(arch, dtype)
        ref_layout = ref_ops.page_layout(single, batch, BATCH)
        port_layout = PI.page_layout(interop.tree_to_torch(single),
                                     interop.tree_to_torch(batch), BATCH)
        rc, pc = _codecs(ref_layout, port_layout, name)
        flat_b = jax.tree.leaves(_randomize(batch, 40))
        raw = [np.asarray(ref_ops.pack_page_ref(
            ref_layout, jax.tree.leaves(_randomize(single, 41 + g))))
            for g in range(2)]
        enc = np.stack([rc.encode(p) for p in raw])
        np.testing.assert_array_equal(
            np.stack([pc.encode(p) for p in raw]), enc)
        slots = [2, 0]
        want = ref_ops.install_pages(ref_layout,
                                     [jnp.asarray(b) for b in flat_b],
                                     jnp.asarray(enc), slots, mode="ref",
                                     codec=rc)
        got = PI.install_pages(port_layout,
                               [interop.to_torch(b) for b in flat_b],
                               torch.from_numpy(enc), slots, codec=pc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                interop.to_numpy(g).reshape(-1).view(np.uint8),
                np.asarray(w).reshape(-1).view(np.uint8))

    def test_staged_group_rows_install_like_a_stack(self):
        single, batch = _cache_trees("qwen2-0.5b", "float32")
        layout = PI.page_layout(interop.tree_to_torch(single),
                                interop.tree_to_torch(batch), BATCH)
        _, pc = _codecs(ref_ops.page_layout(single, batch, BATCH), layout,
                        "int8")
        leaves = [interop.to_torch(b) for b in
                  jax.tree.leaves(_randomize(batch, 50))]
        raw = [np.asarray(ref_ops.pack_page_ref(
            ref_ops.page_layout(single, batch, BATCH),
            jax.tree.leaves(_randomize(single, 51 + g)))) for g in range(3)]
        group = torch.from_numpy(np.stack([pc.encode(p) for p in raw]))
        a = PI.install_pages(layout, [l.clone() for l in leaves],
                             [(group, 2), (group, 0)], [1, 2], codec=pc)
        b = PI.install_pages(layout, [l.clone() for l in leaves],
                             group[[2, 0]], [1, 2], codec=pc)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_codec_for_another_layout_raises(self):
        single, batch = _cache_trees("qwen2-0.5b")
        layout = PI.page_layout(interop.tree_to_torch(single),
                                interop.tree_to_torch(batch), BATCH)
        wrong = codecs.make_codec("int8", layout.page_bytes,
                                  dtype="uint8")
        with pytest.raises(ValueError, match="codec segment mismatch"):
            PI.install_pages(layout, [interop.to_torch(b) for b in
                                      jax.tree.leaves(batch)],
                             torch.zeros(1, wrong.encoded_bytes,
                                         dtype=torch.uint8), [0],
                             codec=wrong)

    def test_bf16_codec_is_lossless_on_bf16_caches(self):
        single, batch = _cache_trees("qwen2-0.5b")
        layout = PI.page_layout(interop.tree_to_torch(single),
                                interop.tree_to_torch(batch), BATCH)
        _, pc = _codecs(ref_ops.page_layout(single, batch, BATCH), layout,
                        "bf16")
        assert pc.encoded_bytes == layout.page_bytes
        assert all(s.kind == "raw" for s in pc.segs)
