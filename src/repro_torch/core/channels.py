"""Multi-channel host<->device transfer engine (the XDMA model).

Twin of ``repro/core/channels.py``.  Each ``Channel`` is a worker thread
with its own submission queue and, on a CUDA device, its own
``torch.cuda.Stream`` — the analogue of one XDMA H2C/C2H hardware
channel.  A ``ChannelPool`` splits large transfers into chunks and
interleaves them round-robin across its channels.

On the card a chunk moves as one asynchronous copy on its channel's
stream, between device memory and a pinned host buffer:

* H2C: the payload is copied into a pinned buffer on the channel thread,
  then ``dst.copy_(pinned, non_blocking=True)`` into a view of one device
  buffer that the pool allocated at submit for the whole transfer;
* C2H: ``pinned.copy_(src, non_blocking=True)`` into a view of one
  pinned buffer allocated at submit, returned as numpy.

Each chunk records a CUDA event after its copy, and the channel thread
settles the chunk when that event completes.  Streams are ordered both
ways: the channel stream first waits on an event the submitter recorded
on its own current stream (so a copy never reads or overwrites memory
that earlier work on that stream still uses), and ``record_stream`` marks
every device tensor that a channel stream touches.  Whoever takes the
H2C result makes its own current stream wait on the chunks' events, so
a kernel it launches next reads the landed bytes.

With ``device="cpu"`` (what the tests ask for) the same pool moves
chunks with plain host copies and no streams.

``Transfer`` *is* a ``cplane.Completion``: the pool registers as a
reactor source, and transfers compose with any other completion via
``wait_any``/``wait_all``/``as_completed``.
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cplane import Completion, default_reactor
from repro_torch.device import resolve_device


class Direction(enum.Enum):
    H2C = "h2c"
    C2H = "c2h"


class CompletionMode(enum.Enum):
    POLLED = "polled"
    INTERRUPT = "interrupt"


def _as_host_tensor(payload) -> torch.Tensor:
    if isinstance(payload, torch.Tensor):
        return payload
    return torch.from_numpy(np.ascontiguousarray(payload))


class Transfer(Completion):
    """One submitted (possibly multi-chunk) transfer — a ``Completion``.

    ``_dest`` is the one buffer every chunk lands in (device memory for
    H2C, pinned host memory for C2H) and ``_dest_views`` its per-chunk
    slices, so the result is assembled in place with no concatenate.
    ``_events`` are the chunks' CUDA events (none on the CPU)."""

    def __init__(self, direction: Direction, n_chunks: int, t_submit: float,
                 device: torch.device,
                 on_complete: Optional[Callable[["Transfer"], None]] = None,
                 source: Optional[str] = None, reactor=None):
        super().__init__(source=source, reactor=reactor)
        self.t_submit = t_submit
        self.direction = direction
        self.n_chunks = n_chunks
        self.device = device
        self.on_complete = on_complete
        self._chunks_done = 0
        self._bytes = 0
        self._errors: list = []
        self._chunk_lock = threading.Lock()
        self._dest = None
        self._dest_views: List[Any] = []
        self._ready: Optional[torch.cuda.Event] = None
        self._events: List[torch.cuda.Event] = []

    def _chunk_done(self, out, nbytes: int) -> None:
        """Record one finished chunk; ``out`` is its CUDA event (None on
        the CPU) or an Exception.  Failed chunks flow through here too,
        so a transfer with one bad chunk still settles (ERROR)."""
        with self._chunk_lock:
            if isinstance(out, Exception):
                self._errors.append(out)
            elif out is not None:
                self._events.append(out)
            self._bytes += nbytes
            self._chunks_done += 1
            finished = self._chunks_done == self.n_chunks
        if finished:
            self.nbytes = self._bytes
            if self._errors:
                self.fail(self._errors[0])
            else:
                self.succeed_lazy(self._assemble_result)
            if self.on_complete is not None:
                self.on_complete(self)

    def _assemble_result(self):
        if self.direction == Direction.C2H:
            return self._dest.numpy()
        if self.device.type == "cuda":
            # the consumer's stream takes the landed bytes: order it after
            # every chunk's copy, and tell the allocator it uses the buffer
            cur = torch.cuda.current_stream(self.device)
            for ev in self._events:
                cur.wait_event(ev)
            self._dest.record_stream(cur)
        return self._dest


class Channel:
    """One DMA channel: a worker thread, a submission queue and (on a
    CUDA device) its own stream."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.stream = torch.cuda.Stream(device=device) \
            if device.type == "cuda" else None
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"nma-{name}")
        self._alive = True
        self.bytes_moved = 0
        self._thread.start()

    def submit(self, item) -> None:
        self._q.put(item)

    def _copy_cuda(self, transfer: Transfer, idx: int,
                   payload) -> torch.cuda.Event:
        dst = transfer._dest_views[idx]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(transfer._ready)
            if transfer.direction == Direction.H2C:
                pinned = torch.empty(payload.shape, dtype=payload.dtype,
                                     pin_memory=True)
                pinned.copy_(payload)
                dst.copy_(pinned, non_blocking=True)
            else:
                dst.copy_(payload, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return done

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            transfer, idx, payload = item
            try:
                if self.stream is not None:
                    out = self._copy_cuda(transfer, idx, payload)
                else:
                    transfer._dest_views[idx].copy_(payload)
                    out = None
                nbytes = transfer._dest_views[idx].nbytes
                self.bytes_moved += nbytes
                transfer._chunk_done(out, nbytes)
            except Exception as e:  # surface errors to the waiter
                transfer._chunk_done(e, 0)

    def close(self) -> None:
        if self._alive:
            self._alive = False
            self._q.put(None)
            self._thread.join(timeout=5)


class ChannelPool:
    """N-channel engine with round-robin chunk interleaving."""

    def __init__(self, n_channels: int = 4, device=None,
                 chunk_bytes: int = 1 << 22, reactor=None,
                 source: Optional[str] = None):
        if n_channels < 1:
            raise ValueError(n_channels)
        self.device = resolve_device(device)
        self.channels = [Channel(f"ch{i}", self.device)
                         for i in range(n_channels)]
        self.chunk_bytes = chunk_bytes
        self._rr = 0
        # completion-plane source: channel threads settle transfers, so
        # the pool registers as an interrupt source; every transfer's
        # latency/bytes feed this source's EWMAs
        self._reactor = reactor if reactor is not None else default_reactor()
        self._source = source or self._reactor.unique_source("xdma-pool")
        self._reactor.register_source(self._source, mode="interrupt")

    def bind_telemetry(self, reactor, source: str) -> None:
        """Re-point this pool's completion telemetry at ``source`` (how
        an access-path adapter claims the transfers it submits)."""
        self._reactor.unregister_source(self._source)
        self._reactor = reactor
        self._source = source
        reactor.register_source(source, mode="interrupt")

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    def _bounds(self, shape, nbytes: int) -> List[tuple]:
        """Axis-0 chunk bounds of ~chunk_bytes each (1 chunk if small)."""
        n0 = shape[0] if len(shape) > 0 else 1
        if nbytes <= self.chunk_bytes or n0 <= 1:
            return [(0, n0)] if len(shape) > 0 else [(None, None)]
        n_chunks = min(n0, max(1, nbytes // self.chunk_bytes))
        n_chunks = min(n_chunks, self.n_channels * 8)
        cuts = np.linspace(0, n0, n_chunks + 1).astype(int)
        return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]

    def submit(self, arr, direction: Direction,
               mode: CompletionMode = CompletionMode.POLLED,
               on_complete: Optional[Callable] = None) -> Transfer:
        """Start moving ``arr``: a host array (numpy or CPU tensor) for
        H2C, a tensor on the pool's device for C2H."""
        cuda = self.device.type == "cuda"
        if direction == Direction.H2C:
            src = _as_host_tensor(arr)
            dest = torch.empty(src.shape, dtype=src.dtype,
                               device=self.device)
        else:
            if not isinstance(arr, torch.Tensor) or \
                    arr.device != self.device:
                raise ValueError(f"C2H takes a tensor on {self.device}")
            src = arr.contiguous()
            dest = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
        bounds = self._bounds(tuple(src.shape), src.nbytes)
        tr = Transfer(direction=direction, n_chunks=len(bounds),
                      t_submit=time.perf_counter(), device=self.device,
                      on_complete=on_complete if
                      mode == CompletionMode.INTERRUPT else None,
                      source=self._source, reactor=self._reactor)
        tr._dest = dest
        tr._dest_views = [dest if a is None else dest[a:b]
                          for a, b in bounds]
        chans = []
        for _ in bounds:
            chans.append(self.channels[self._rr % self.n_channels])
            self._rr += 1
        if cuda:
            # order the channel streams after the submitter's stream, and
            # mark the device tensors they touch
            cur = torch.cuda.current_stream(self.device)
            tr._ready = torch.cuda.Event()
            tr._ready.record(cur)
            dev_t = dest if direction == Direction.H2C else src
            for ch in {id(c): c for c in chans}.values():
                dev_t.record_stream(ch.stream)
        for i, ((a, b), ch) in enumerate(zip(bounds, chans)):
            ch.submit((tr, i, src if a is None else src[a:b]))
        return tr

    # convenience wrappers -------------------------------------------------
    def h2c(self, host_arr, **kw) -> Transfer:
        return self.submit(host_arr, Direction.H2C, **kw)

    def c2h(self, dev_arr, **kw) -> Transfer:
        return self.submit(dev_arr, Direction.C2H, **kw)

    def drain(self, transfers: Sequence[Transfer]) -> list:
        """Wait for every transfer; their results, in order."""
        return [t.wait() for t in transfers]

    def close(self) -> None:
        for c in self.channels:
            c.close()
        self._reactor.unregister_source(self._source)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
