"""The port's data pipeline against the reference's: documents, packed
batches byte for byte (sharded too), ``state``/``restore``, the memory-
mapped corpus, and the ``DevicePrefetcher`` staging the batcher's
batches through the ``ChannelPool`` in order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as RP  # noqa: E402
from repro_torch.data import pipeline as PP  # noqa: E402


@pytest.mark.parametrize("vocab,seed,mean", [(256, 0, 512), (151936, 3, 64)])
def test_synthetic_documents_equal(vocab, seed, mean):
    ref = RP.SyntheticCorpus(vocab, seed=seed, mean_doc_len=mean)
    port = PP.SyntheticCorpus(vocab, seed=seed, mean_doc_len=mean)
    for a, b in zip(port.documents(5, 7), ref.documents(5, 7)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("B,S,shard,shards", [(2, 32, 0, 1), (8, 128, 0, 1),
                                              (4, 64, 1, 3), (3, 17, 2, 3)])
def test_packed_batches_byte_equal(B, S, shard, shards):
    spec = (B, S)
    ref = RP.PackedBatcher(RP.SyntheticCorpus(512, seed=2),
                           RP.BatchSpec(*spec), shard, shards)
    port = PP.PackedBatcher(PP.SyntheticCorpus(512, seed=2),
                            PP.BatchSpec(*spec), shard, shards)
    for _ in range(4):
        a, b = port.next_batch(), ref.next_batch()
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].shape == (B, S) and a[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
        assert port.state() == ref.state()


def test_state_restore_replays_the_stream():
    port = PP.PackedBatcher(PP.SyntheticCorpus(300), PP.BatchSpec(2, 40))
    port.next_batch()
    saved = port.state()
    want = [port.next_batch() for _ in range(3)]
    fresh = PP.PackedBatcher(PP.SyntheticCorpus(300), PP.BatchSpec(2, 40))
    fresh.restore(saved)
    ref = RP.PackedBatcher(RP.SyntheticCorpus(300), RP.BatchSpec(2, 40))
    ref.restore(saved)
    for w in want:
        got, r = fresh.next_batch(), ref.next_batch()
        assert got["tokens"].tobytes() == w["tokens"].tobytes() == \
            r["tokens"].tobytes()


def test_mmap_corpus_matches_reference(tmp_path):
    docs = [np.arange(n, dtype=np.int32) % 97 for n in (5, 40, 9, 120, 33)]
    PP.MMapCorpus.write(str(tmp_path / "p.bin"), docs)
    RP.MMapCorpus.write(str(tmp_path / "r.bin"), docs)
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "r.bin").read_bytes()
    port, ref = PP.MMapCorpus(str(tmp_path / "p.bin")), \
        RP.MMapCorpus(str(tmp_path / "r.bin"))
    assert port.n_docs == ref.n_docs == 5
    for a, b in zip(port.documents(3, 6), ref.documents(3, 6)):
        assert a.tobytes() == b.tobytes()
    pb = PP.PackedBatcher(port, PP.BatchSpec(2, 16))
    rb = RP.PackedBatcher(ref, RP.BatchSpec(2, 16))
    assert pb.next_batch()["labels"].tobytes() == \
        rb.next_batch()["labels"].tobytes()


def test_device_prefetcher_stages_batches_in_order():
    want = PP.PackedBatcher(PP.SyntheticCorpus(256), PP.BatchSpec(2, 24))
    pre = PP.DevicePrefetcher(
        PP.PackedBatcher(PP.SyntheticCorpus(256), PP.BatchSpec(2, 24)),
        depth=2, n_channels=2, device="cpu")
    try:
        for _ in range(5):
            got, w = next(pre), want.next_batch()
            for k in w:
                assert isinstance(got[k], torch.Tensor)
                assert got[k].dtype == torch.int32
                assert got[k].numpy().tobytes() == w[k].tobytes()
    finally:
        pre.close()
    assert not pre._thread.is_alive()


PREFETCH_CHILD = r"""
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.data import pipeline as PP
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
spec = PP.BatchSpec(4, 8)
want = PP.PackedBatcher(PP.SyntheticCorpus(256), spec)
pre = PP.DevicePrefetcher(PP.PackedBatcher(PP.SyntheticCorpus(256), spec),
                          sharding=(mesh, (Shard(0),)), device="cpu")
ok = []
for _ in range(3):
    got, w = next(pre), want.next_batch()
    for k in w:
        t = got[k]
        rows = w[k][RANK * 2:RANK * 2 + 2]
        ok.append(isinstance(t, DTensor) and t.placements == (Shard(0),)
                  and t.to_local().numpy().tobytes() == rows.tobytes()
                  and t.full_tensor().numpy().tobytes() == w[k].tobytes())
pre.close()
done({"ok": all(ok), "n": len(ok)})
"""


def test_prefetcher_raises_for_sharding_and_wants_a_card_by_default(
        tmp_path):
    """``sharding=`` places each staged leaf as a DTensor over a gloo
    mesh of 2 CPU ranks: each rank keeps its 2 of the batch's 4 rows and
    the whole is the batcher's batch; without a card the default device
    raises."""
    from torch_ranks import run_ranks
    out = run_ranks(PREFETCH_CHILD, 2, tmp_path, timeout=120)
    assert out == {"ok": True, "n": 6}
    b = PP.PackedBatcher(PP.SyntheticCorpus(256), PP.BatchSpec(2, 8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PP.DevicePrefetcher(b)


def test_prefetcher_surfaces_a_batcher_error():
    class Broken:
        def next_batch(self):
            raise ValueError("corpus gone")
    pre = PP.DevicePrefetcher(Broken(), device="cpu")
    try:
        with pytest.raises(ValueError, match="corpus gone"):
            next(pre)
    finally:
        pre.close()
