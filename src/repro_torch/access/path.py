"""The unified memory-access surface: ``MemoryPath`` + ``PathCapabilities``.

Twin of ``repro/access/path.py``.  ``MemoryPath`` is the one protocol
every access mechanism satisfies; ``PathCapabilities`` is the descriptor
a policy scores to pick a path per request.  A path exposes two op
families:

* **page ops** — ``write``/``read``/``write_many``/``read_many`` (sync)
  and ``write_many_async``/``read_many_async`` (returning ``PendingIO``):
  fixed-size byte pages in the path's cold memory;
* **stage ops** — ``stage_h2c``/``stage_c2h`` (returning ``Transfer``):
  host<->device staging through the path's DMA mechanism.

``MemoryPath`` is a strict superset of ``rmem.TierBackend``: the
``store``/``load`` spellings remain as aliases, so a path drops into
``TieredStore`` wherever a bare backend was accepted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.analytical import PathModel, doorbell_bandwidth_gbps
from repro_torch.core.channels import CompletionMode, Direction, Transfer
from repro_torch.rmem.backend import PendingIO


@dataclass(frozen=True)
class PathCapabilities:
    """What a path can do and what it costs — the selector's input.

    ``model`` is the analytical model of the path's own transfer mechanism
    (page ops); ``stage_model`` is the model of its host<->device staging
    leg, which for a verbs path is still plain PCIe DMA.  ``projected_*``
    are the ``core.analytical`` cost hooks: one work request of
    ``nbytes``, with the per-op setup amortized over ``batch`` iff the
    path coalesces batches (doorbell ring / descriptor ring).
    """

    kind: str                       # "xdma" | "qdma" | "verbs" | "auto"
    granularity_bytes: int          # smallest efficient transfer unit
    max_inflight: int               # concurrent ops before back-pressure
    batch_coalescing: bool          # batched ops share one setup cost
    completion_modes: Tuple[CompletionMode, ...]
    channels: int                   # parallel engines aggregating the link
    model: PathModel
    stage_model: Optional[PathModel] = None

    def _model_for(self, stage: bool) -> PathModel:
        if stage and self.stage_model is not None:
            return self.stage_model
        return self.model

    def projected_gbps(self, nbytes: int, batch: int = 1,
                       direction: Direction = Direction.C2H,
                       stage: bool = False,
                       contended: bool = False) -> float:
        eff_batch = batch if self.batch_coalescing else 1
        return doorbell_bandwidth_gbps(
            self._model_for(stage), nbytes, max(eff_batch, 1),
            self.channels, direction, contended)

    def projected_seconds(self, nbytes: int, batch: int = 1,
                          direction: Direction = Direction.C2H,
                          stage: bool = False) -> float:
        """Modeled seconds for ONE op of ``nbytes`` at this batch depth."""
        bw = self.projected_gbps(nbytes, batch, direction, stage)
        return nbytes / (bw * 1e9)


@runtime_checkable
class MemoryPath(Protocol):
    """One access mechanism behind the unified surface."""

    name: str
    n_pages: int
    page_bytes: int

    def capabilities(self) -> PathCapabilities: ...

    # -- page ops (cold memory behind the path) --------------------------
    def write(self, page: int, value: np.ndarray) -> None: ...

    def read(self, page: int) -> np.ndarray: ...

    def write_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None: ...

    def read_many(self, pages: Sequence[int]) -> np.ndarray: ...

    def write_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO: ...

    def read_many_async(self, pages: Sequence[int]) -> PendingIO: ...

    # -- stage ops (host <-> device arrays) ------------------------------
    def stage_h2c(self, host_arr, on_complete=None,
                  qname: str = "default") -> Transfer: ...

    def stage_c2h(self, dev_arr, on_complete=None,
                  qname: str = "default") -> Transfer: ...

    def occupancy(self) -> float: ...

    def stats(self) -> dict: ...

    def close(self) -> None: ...


class TierBackendCompat:
    """``TierBackend``-spelling aliases + model hooks over the canonical
    ``MemoryPath`` page ops, so any path (or selector) drops into
    ``TieredStore`` where a bare backend was accepted."""

    def store(self, page: int, value: np.ndarray) -> None:
        return self.write(page, value)

    def load(self, page: int) -> np.ndarray:
        return self.read(page)

    def store_many(self, pages: Sequence[int],
                   values: Sequence[np.ndarray]) -> None:
        return self.write_many(pages, values)

    def load_many(self, pages: Sequence[int]) -> np.ndarray:
        return self.read_many(pages)

    def store_many_async(self, pages: Sequence[int],
                         values: Sequence[np.ndarray]) -> PendingIO:
        return self.write_many_async(pages, values)

    def load_many_async(self, pages: Sequence[int]) -> PendingIO:
        return self.read_many_async(pages)

    def path_model(self) -> PathModel:
        return self.capabilities().model

    def projected_seconds(self, nbytes: int, batch: int = 1,
                          direction: Direction = Direction.C2H) -> float:
        return self.capabilities().projected_seconds(nbytes, batch,
                                                     direction)


def unified_stats(path_name: str, bytes_moved: int, ops: int,
                  projected_s: float, **extra) -> dict:
    """The one stats schema every access surface now emits.

    Top-level keys are always ``path``/``bytes_moved``/``ops``/
    ``projected_s``; mechanism-specific detail nests under its own keys
    (``channels``, ``qp``, ``members``, legacy backend counters...).
    """
    out = {"path": path_name, "bytes_moved": int(bytes_moved),
           "ops": int(ops), "projected_s": float(projected_s)}
    out.update(extra)
    return out
