"""Data pipeline: corpora -> SG-packed batches -> device prefetch.

Twin of ``repro/data/pipeline.py``.  Batch assembly *is* a
scatter-gather DMA: document spans are SG descriptors gathered into
fixed (B, S) rows; assembled batches stream host->device through the
NMA ``ChannelPool`` with double buffering, so step N's H2C overlaps step
N-1's compute (the paper's H2C path).  The corpora and the packing are
numpy, as in the reference, so both packages draw byte-equal batches.

Each process loads only its data shard (``shard_id``/``num_shards``).
``DevicePrefetcher(sharding=)`` places each staged batch leaf as a
DTensor over a device mesh, where the reference ``device_put``s it:
``sharding`` is one ``(mesh, placements)`` for every leaf or a dict of
them by key (``repro_torch.sharding.tree_shardings``' form).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.channels import ChannelPool
from repro_torch.core.descriptors import gather, spans_for_packing
from repro_torch.sharding import distribute_tree


class SyntheticCorpus:
    """Deterministic skewed-zipf token stream with document structure."""

    def __init__(self, vocab: int, seed: int = 0,
                 mean_doc_len: int = 512):
        self.vocab = vocab
        self.seed = seed
        self.mean_doc_len = mean_doc_len

    def documents(self, start_doc: int, n_docs: int):
        """Deterministic access to documents [start_doc, start_doc+n)."""
        out = []
        for d in range(start_doc, start_doc + n_docs):
            rng = np.random.default_rng((self.seed << 20) ^ d)
            L = max(8, int(rng.exponential(self.mean_doc_len)))
            # zipf-ish skew bounded to vocab
            toks = rng.zipf(1.3, size=L) % self.vocab
            out.append(toks.astype(np.int32))
        return out


class MMapCorpus:
    """Flat binary token file (int32) with a doc-offset index (.idx.npy)."""

    def __init__(self, path: str):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.offsets = np.load(path + ".idx.npy")  # (n_docs+1,)

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    def documents(self, start_doc: int, n_docs: int):
        out = []
        for d in range(start_doc, start_doc + n_docs):
            i = d % self.n_docs
            out.append(np.asarray(
                self.tokens[self.offsets[i]:self.offsets[i + 1]]))
        return out

    @staticmethod
    def write(path: str, docs) -> None:
        flat = np.concatenate(docs).astype(np.int32)
        flat.tofile(path)
        offs = np.zeros(len(docs) + 1, np.int64)
        np.cumsum([len(d) for d in docs], out=offs[1:])
        np.save(path + ".idx.npy", offs)


@dataclass
class BatchSpec:
    batch: int          # per-shard batch size
    seq_len: int


class PackedBatcher:
    """SG-gather sequence packing into (B, S) token/label rows."""

    def __init__(self, corpus, spec: BatchSpec, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 0):
        self.corpus = corpus
        self.spec = spec
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._doc_cursor = shard_id  # stride by num_shards for disjointness
        self._docs_per_fetch = max(4, spec.batch)

    def state(self) -> Dict:
        return {"doc_cursor": self._doc_cursor}

    def restore(self, state: Dict) -> None:
        self._doc_cursor = state["doc_cursor"]

    def next_batch(self) -> Dict[str, np.ndarray]:
        B, S = self.spec.batch, self.spec.seq_len
        need = B * (S + 1)
        docs, lens = [], []
        total = 0
        while total < need:
            fetched = self.corpus.documents(self._doc_cursor,
                                            self._docs_per_fetch)
            # strided sharding: this shard owns docs where
            # (doc_id % num_shards) == shard_id
            for off, d in enumerate(fetched):
                if (self._doc_cursor + off) % self.num_shards == \
                        self.shard_id:
                    docs.append(d)
                    lens.append(len(d))
                    total += len(d)
            self._doc_cursor += self._docs_per_fetch
        flat = np.concatenate(docs)
        sg, _rows = spans_for_packing(lens, S + 1, itemsize=4)
        # keep only the rows we need
        dst = gather(flat, sg, dst_size=(total // (S + 1) + 1)
                     * (S + 1) * 4).view(np.int32)
        rows = dst.reshape(-1, S + 1)[:B]
        return {"tokens": rows[:, :-1].copy(),
                "labels": rows[:, 1:].copy()}


class DevicePrefetcher:
    """Double-buffered H2C staging of batches through the ChannelPool.

    ``device`` is the pool's (None means ``"cuda"``) when no ``pool`` is
    handed in; a pool handed in is the caller's to close.  With
    ``sharding`` (module note) each leaf staged on the device becomes a
    DTensor of which every rank keeps its own slice: the producer thread
    issues no collective."""

    def __init__(self, batcher: PackedBatcher, pool: Optional[ChannelPool]
                 = None, depth: int = 2, n_channels: int = 2,
                 sharding=None, device=None):
        self.batcher = batcher
        self._owns_pool = pool is None
        self.pool = pool or ChannelPool(n_channels, device=device)
        self.sharding = sharding
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _stage(self, host_batch):
        trs = {k: self.pool.h2c(v) for k, v in host_batch.items()}
        batch = {k: t.wait() for k, t in trs.items()}
        if self.sharding is None:
            return batch
        return distribute_tree(batch, self.sharding, src_data_rank=None)

    def _producer(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._stage(self.batcher.next_batch())
            except Exception as e:          # surfaced by __next__
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, BaseException):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        batch = self._q.get()
        if isinstance(batch, BaseException):
            raise batch
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._owns_pool:
            self.pool.close()
