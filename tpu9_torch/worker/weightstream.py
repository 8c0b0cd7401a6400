"""Double-buffered weight streaming: chunks → host buffer → device, the
port's copy of ``tpu9/worker/weightstream.py``.

The chunk stream fills a preallocated buffer per shard, the shard becomes a
zero-copy typed view the moment its last chunk lands, and the consumer
stage (the copy to the card) runs in a worker thread for shard *i* while
the loop keeps fetching shard *i+1*, so a restore's wall-clock approaches
max(fetch, consume) instead of their sum.

The consumer for the card (:func:`make_device_put`) stages each shard
through a small ring of pinned host buffers, allocated once, and queues
each piece's host-to-device copy on a stream of its own, into a destination
allocated on that stream, so the copy of one piece overlaps the staging of
the next, no leaf, however large, needs a pinned buffer of its size, and a
restore runs beside graph captures on another thread. The unchanged
reference worker takes it as its ``device_put``
(``CheckpointManager.restore_params``), which hands it numpy arrays.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, AsyncIterator, Callable, Optional, Sequence

import numpy as np
import torch

from ..serving import weights as wfmt

# consumer of one completed shard: (leaf_entry, host array) -> Any
Consume = Callable[[dict, Any], Any]

RING_SLOTS = 2
RING_SLOT_BYTES = 64 << 20


class DevicePut:
    """The consumer ``(entry, host_array) -> tensor on device``. On a CUDA
    device each shard moves in ring-sized pieces: a piece is copied into a
    free pinned slot, its copy to the card is queued on the copy stream
    with ``non_blocking=True`` and an event is recorded for the slot, which
    is reused only after that event. Before it returns, the call waits for
    its own copies, as the reference blocks on ``block_until_ready``.

    Calls are serialised by a lock (the ring has one owner at a time); the
    device is set in the calling thread, which is ``asyncio.to_thread``'s
    worker under :func:`stream_shards`."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.slots = RING_SLOTS
        self.slot_bytes = RING_SLOT_BYTES
        self._lock = threading.Lock()
        self._ring: list[torch.Tensor] = []
        self._events: list = []
        self._stream = None
        self.pinned_bytes = 0       # the ring's pinned bytes

    def _alloc_ring(self) -> None:
        before = _host_pinned()
        self._ring = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                  pin_memory=True)
                      for _ in range(self.slots)]
        self._events = [None] * self.slots
        self._stream = torch.cuda.Stream(self.device)
        # the caching host allocator rounds each pinned block up to a power
        # of two: the ring holds what the allocator grew by, or (where it
        # handed out cached blocks) the rounded size of its slots
        grown = _host_pinned() - before
        rounded = 1 << (self.slot_bytes - 1).bit_length()
        self.pinned_bytes = grown if grown > 0 else rounded * self.slots

    def __call__(self, entry: dict, arr) -> torch.Tensor:
        t = arr if isinstance(arr, torch.Tensor) else wfmt.from_numpy(arr)
        return self.move(t).reshape(list(entry["shape"]))

    def move(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor's copy on the device, same dtype and shape."""
        if t.device.type != "cpu":
            raise ValueError(f"a host shard is on {t.device}")
        if t.numel() == 0:
            return torch.empty(t.shape, dtype=t.dtype, device=self.device)
        src = wfmt.byte_view(t)
        if self.device.type != "cuda":
            out = src.clone()
        else:
            with self._lock, torch.cuda.device(self.device):
                if not self._ring:
                    self._alloc_ring()
                out = self._put(src)
        return out.view(t.dtype).reshape(t.shape)

    def _put(self, src: torch.Tensor) -> torch.Tensor:
        n = src.numel()
        # the destination is allocated on the copy stream, so the put
        # touches no stream but its own (captures on another thread run
        # beside it); its memory is not handed out again before the work
        # the caller's stream has queued by the time it is freed
        with torch.cuda.stream(self._stream):
            dst = torch.empty(n, dtype=torch.uint8, device=self.device)
        dst.record_stream(torch.cuda.current_stream(self.device))
        piece = 0
        for off in range(0, n, self.slot_bytes):
            m = min(self.slot_bytes, n - off)
            j = piece % self.slots
            piece += 1
            if self._events[j] is not None:
                self._events[j].synchronize()     # slot j's copy has run
            slot = self._ring[j][:m]
            slot.copy_(src[off:off + m])
            with torch.cuda.stream(self._stream):
                dst[off:off + m].copy_(slot, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
            self._events[j] = ev
        self._stream.synchronize()
        self._events = [None] * self.slots
        return dst


def _host_pinned() -> int:
    """Bytes of pinned blocks the caching host allocator owns (0 where this
    PyTorch has no such statistic)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return int(stats().get("allocated_bytes.current", 0)) if stats else 0


_DEFAULT: dict = {}
_DEFAULT_LOCK = threading.Lock()


def make_device_put(device) -> DevicePut:
    """A consumer that puts each shard on ``device`` through its own ring
    of pinned buffers (allocated at its first CUDA call). ``"cpu"`` gives
    a plain copy, for the tests."""
    return DevicePut(device)


def default_consumer() -> DevicePut:
    """The process's consumer for the calling thread's current CUDA device
    (one ring per device, kept for the process); raises without a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: default_device_put needs one "
                           "(pass make_device_put('cpu') to copy on the CPU)")
    idx = torch.cuda.current_device()
    with _DEFAULT_LOCK:
        if idx not in _DEFAULT:
            _DEFAULT[idx] = DevicePut(torch.device("cuda", idx))
        return _DEFAULT[idx]


def default_device_put(entry: dict, arr) -> torch.Tensor:
    """Blocking host→device transfer to the current CUDA device (runs in a
    worker thread); raises without one."""
    return default_consumer()(entry, arr)


def _place_chunk(buf: np.ndarray, fill: int, data) -> None:
    """Copy one chunk into the shard buffer at ``fill``. ``np.copyto``
    releases the interpreter lock for the copy (a memoryview slice
    assignment holds it), so Python threads beside a restore, such as an
    engine capturing its windows, are not held behind each chunk's copy."""
    np.copyto(buf[fill:fill + len(data)], np.frombuffer(data, dtype=np.uint8))


async def stream_shards(
        entries: Sequence[dict],
        chunks: AsyncIterator[tuple[str, Optional[bytes]]],
        consume: Optional[Consume] = None) -> tuple[list, dict]:
    """Drive the pipeline: ``entries`` are index leaf dicts (stream order);
    ``chunks`` yields that order's concatenated chunk stream (chunks never
    straddle shard files). Returns the consumer results in leaf order plus
    phase metrics.

    Each shard lands in a fresh buffer, which the consumer may keep.

    Metrics:

    - ``fetch_s``: time spent awaiting the chunk stream
    - ``put_s``: time spent *blocked* on the consumer stage (overlapped
      consumer work costs nothing here)
    - ``consume_s``: total consumer work (in-thread), overlapped or not
    - ``wall_s`` / ``bytes`` / ``shards``: totals
    - interval anchors: ``wall_anchor`` (one wall stamp at stream start)
      plus monotonic pairs ``start_mono``/``end_mono``,
      ``fetch_{first,last}_mono`` (first chunk await → last chunk landed)
      and ``put_{first,last}_mono`` (first consume start → last consume
      end). Duration math stays monotonic; the wall stamp is an anchor.
    """
    consume = consume or default_device_put
    wall_anchor = time.time()
    t_wall = time.monotonic()
    fetch_s = 0.0
    put_s = 0.0
    total = 0
    # [first_mono, last_mono] windows; only ONE consume runs at a time
    # (double buffering settles i-1 before launching i), so the plain
    # list mutated from the worker thread is race-free
    fetch_win: list = [None, None]
    put_win: list = [None, None]
    consume_s = [0.0]
    results: list = [None] * len(entries)
    pending: Optional[asyncio.Task] = None
    pending_i = -1

    def timed_consume(entry: dict, arr) -> Any:
        t0 = time.monotonic()
        if put_win[0] is None:
            put_win[0] = t0
        try:
            return consume(entry, arr)
        finally:
            put_win[1] = time.monotonic()
            consume_s[0] += put_win[1] - t0

    async def settle() -> None:
        nonlocal pending, pending_i, put_s
        if pending is None:
            return
        t0 = time.monotonic()
        results[pending_i] = await pending
        put_s += time.monotonic() - t0
        pending = None

    try:
        for i, entry in enumerate(entries):
            need = int(entry["nbytes"])
            buf = np.empty(need, dtype=np.uint8)  # no zeroing: fully overwritten
            fill = 0
            while fill < need:
                t0 = time.monotonic()
                if fetch_win[0] is None:
                    fetch_win[0] = t0
                try:
                    digest, data = await chunks.__anext__()
                except StopAsyncIteration:
                    raise IOError(
                        f"weight stream ended early: shard {entry['file']} "
                        f"has {fill}/{need} bytes") from None
                finally:
                    fetch_win[1] = time.monotonic()
                    fetch_s += fetch_win[1] - t0
                if data is None:
                    raise IOError(f"missing chunk {digest} for shard "
                                  f"{entry['file']}")
                if fill + len(data) > need:
                    raise IOError(
                        f"shard {entry['file']} overflows: {fill}+"
                        f"{len(data)} > {need} (chunk straddles shards?)")
                _place_chunk(buf, fill, data)
                fill += len(data)
            total += need
            arr = wfmt.shard_to_array(buf, entry)
            # double buffer: block on shard i-1's consumer before handing
            # over shard i — fetch of i+1 then overlaps consume of i
            await settle()
            pending_i = i
            pending = asyncio.create_task(
                asyncio.to_thread(timed_consume, entry, arr))
        await settle()
    except BaseException:
        if pending is not None:
            pending.cancel()
            await asyncio.gather(pending, return_exceptions=True)
        raise
    end_mono = time.monotonic()
    return results, {"fetch_s": round(fetch_s, 4),
                     "put_s": round(put_s, 4),
                     "consume_s": round(consume_s[0], 4),
                     "wall_s": round(end_mono - t_wall, 4),
                     "bytes": total, "shards": len(entries),
                     "wall_anchor": wall_anchor,
                     "start_mono": t_wall, "end_mono": end_mono,
                     "fetch_first_mono": fetch_win[0],
                     "fetch_last_mono": fetch_win[1],
                     "put_first_mono": put_win[0],
                     "put_last_mono": put_win[1]}
