"""End-to-end page integrity: checksums stamped on store, verified on
fetch (§9).

DMA paths have no payload protection in this simulation (and weak
protection in practice: PCIe LCRC covers the link, not host bugs or
NIC DMA engine errata — the BlueField-2 characterization calls out
exactly this class of silent corruption).  ``PageChecksums`` gives the
tier/fabric layers a cheap end-to-end check: a crc32 + length stamped
when a page's bytes are handed to a backend, verified when bytes come
back.

The checksum covers only the first ``nbytes`` of the page buffer —
member staging rows are page-sized and short writes leave stale tail
bytes, which are not data.

``IntegrityError`` subclasses ``TransientIOError`` deliberately: on a
sharded path a re-read can land on a *different replica* and succeed,
so corruption is transient from the reader's point of view; only when
every replica fails verification does it become a hard loss.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.faults.retry import TransientIOError


class IntegrityError(TransientIOError):
    """A fetched page failed checksum verification."""


def page_crc(data: np.ndarray) -> Tuple[int, int]:
    """(crc32, nbytes) over a page's bytes, dtype-agnostic."""
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return zlib.crc32(raw.tobytes()) & 0xFFFFFFFF, raw.size


class PageChecksums:
    """Thread-safe per-page (crc32, nbytes) map.

    ``stamp`` on store, ``verify`` on fetch, ``drop`` on release.
    Pages never stamped verify trivially (there is nothing to check
    against — e.g. a slot read back before its first write).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sums: Dict[int, Tuple[int, int]] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._sums)

    def stamp(self, page: int, data: np.ndarray) -> None:
        crc = page_crc(data)
        with self._lock:
            self._sums[page] = crc

    def expected(self, page: int):
        with self._lock:
            return self._sums.get(page)

    def check(self, page: int, data: np.ndarray) -> bool:
        """True when ``data`` matches the stamp (or no stamp exists)."""
        exp = self.expected(page)
        if exp is None:
            return True
        crc, nbytes = exp
        raw = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return zlib.crc32(raw[:nbytes].tobytes()) & 0xFFFFFFFF == crc

    def verify(self, page: int, data: np.ndarray) -> None:
        if not self.check(page, data):
            raise IntegrityError(f"page {page}: checksum mismatch on fetch")

    def drop(self, page: int) -> None:
        with self._lock:
            self._sums.pop(page, None)

    def pages(self):
        with self._lock:
            return list(self._sums)
