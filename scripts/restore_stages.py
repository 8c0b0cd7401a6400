#!/usr/bin/env python3
"""Host-side stages of a weight restore, each timed alone on the machine it runs on.

    python3 scripts/restore_stages.py [GIB]

Writes one file of GIB GiB (default 2) under ``build/restore-stages/`` and
times, at the restore's chunk size (4 MiB, the worker's snapshot chunk):

- reading the file in chunks, from the page cache, after its pages are
  dropped (``posix_fadvise(DONTNEED)``; the share of its pages still
  cached and the filesystem are printed, since some keep their pages),
  and with ``O_DIRECT`` where the filesystem takes it;
- allocating a shard-sized buffer and filling it chunk by chunk, as
  ``stream_shards`` does, with a ``bytearray`` (zeroed when allocated) and
  with ``np.empty`` (not zeroed; numpy advises huge pages for large
  arrays), and filling the same buffer again (no page faults), through a
  memoryview and through numpy's slice assignment;
- on a CUDA device, ``make_device_put``'s move of a filled host tensor
  (staging into the pinned ring, then the copy to the card) and a plain
  pinned ``copy_`` of the same bytes.

Prints one line a stage with GB/s, then the card's name and power limit
and the transparent-huge-page mode. The file is deleted at the end.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CHUNK = 4 << 20

from chip_smoke import (direct_chunks, direct_reads_work,  # noqa: E402
                        fs_type, page_cache_share)


def rate(label: str, nbytes: int, seconds: float) -> None:
    print(f"{label}: {seconds:.3f} s, {nbytes / seconds / 1e9:.3f} GB/s")


def read_chunks(path: Path) -> tuple[int, float]:
    t0 = time.perf_counter()
    n = 0
    with open(path, "rb", buffering=0) as f:
        while data := f.read(CHUNK):
            n += len(data)
    return n, time.perf_counter() - t0


def fill(buf, chunks: list[bytes], numpy: bool = False) -> float:
    """Copy the chunks into ``buf`` one after another, through a
    memoryview (or numpy's slice assignment); returns the seconds."""
    view = buf if numpy else memoryview(buf)
    t0 = time.perf_counter()
    off = 0
    for data in chunks:
        view[off:off + len(data)] = (np.frombuffer(data, np.uint8) if numpy
                                     else data)
        off += len(data)
    return time.perf_counter() - t0


def main() -> int:
    gib = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    nbytes = int(gib * (1 << 30)) // CHUNK * CHUNK
    work = ROOT / "build" / "restore-stages"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = work / "shard.bin"
    try:
        block = np.random.default_rng(0).integers(
            0, 256, CHUNK, dtype=np.uint8).tobytes()
        with open(path, "wb") as f:
            for _ in range(nbytes // CHUNK):
                f.write(block)
        read_chunks(path)
        rate("read in 4 MiB chunks, page cache", *read_chunks(path))
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        os.close(fd)
        cached = page_cache_share([str(path)])
        rate(f"read in 4 MiB chunks, pages dropped ({cached:.2%} still "
             f"cached on {fs_type(str(path))})", *read_chunks(path))
        if direct_reads_work(str(path)):
            t0 = time.perf_counter()
            n = sum(len(d) for _, d in direct_chunks(str(path), CHUNK))
            rate("read in 4 MiB chunks, O_DIRECT", n,
                 time.perf_counter() - t0)
        else:
            print("read in 4 MiB chunks, O_DIRECT: refused by the "
                  "filesystem")

        chunks = [block] * (nbytes // CHUNK)
        t0 = time.perf_counter()
        buf = bytearray(nbytes)
        t_alloc = time.perf_counter() - t0
        t_fill = fill(buf, chunks)
        rate("bytearray(n): allocate and zero", nbytes, t_alloc)
        rate("bytearray: first fill", nbytes, t_fill)
        rate("bytearray: second fill", nbytes, fill(buf, chunks))
        del buf
        t0 = time.perf_counter()
        arr = np.empty(nbytes, dtype=np.uint8)
        t_alloc = time.perf_counter() - t0
        rate("np.empty(n): allocate", nbytes, t_alloc)
        rate("np.empty: first fill", nbytes, fill(arr, chunks))
        rate("np.empty: second fill", nbytes, fill(arr, chunks))
        rate("np.empty: third fill, numpy slice assignment", nbytes,
             fill(arr, chunks, numpy=True))

        if torch.cuda.is_available():
            from tpu9_torch.worker.weightstream import make_device_put
            host = torch.from_numpy(arr)
            put = make_device_put("cuda")
            put.move(host[:CHUNK])                     # ring, stream, context
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = put.move(host)
            torch.cuda.synchronize()
            rate(f"make_device_put move ({put.slots} x {put.slot_bytes} B "
                 f"pinned ring, {put.pinned_bytes} B)", nbytes,
                 time.perf_counter() - t0)
            check = torch.equal(dev[:CHUNK].cpu(), host[:CHUNK])
            del dev
            pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            pinned.copy_(host)
            dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            dev.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize()
            rate("pinned copy_ host to device", nbytes,
                 time.perf_counter() - t0)
            t0 = time.perf_counter()
            pinned.copy_(host)
            rate(f"host copy_ into pinned memory ({torch.get_num_threads()} "
                 f"threads)", nbytes, time.perf_counter() - t0)
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True)
            print(f"card: {smi.stdout.strip()}; first chunk moved intact: "
                  f"{check}")
        else:
            print("no CUDA device: the device stages were not run")
        thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")
        print(f"transparent huge pages: "
              f"{thp.read_text().strip() if thp.exists() else 'unknown'}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
