"""Page-locked staging of read-only host arrays on their way to one card.

A tile store hands the screener read-only memory mappings. torch takes no
read-only array without a copy of its own, and a copy to the card from
pageable memory goes through the driver's bounce buffer and returns only
when it is done. `PinnedStaging.to_device` writes such an array straight
from its mapping into a page-locked ring that lives as long as the
screener, queues the copy to the card (`non_blocking`) on the screener's
stream and records an event after it. The source has been read in full
when `to_device` returns (the host memcpy is synchronous); the card's
copy runs on behind it.

`StagingRing` hands out the ring's regions in order, and takes one back
only once the event recorded after the copy from it has completed: a
claim that would overlap a region still in flight waits for that event
first, so no region is written while the card may still read it. The
ring is at least twice the largest claim and is allocated anew (a power
of two) only when a claim exceeds half of it, so a screen that repeats
the same batches allocates page-locked memory on its first pass alone.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading

import numpy as np
import torch

from ..utils import profiling

ALIGN = 4096  # every region starts on a page
MIN_RING = 1 << 24  # 16 MiB
SPLIT = 1 << 23  # arrays from 8 MiB up are copied in as many parts as threads


def stages(a: np.ndarray, device: torch.device) -> bool:
    """True where `BatchScreener._to_device` stages `a`: a non-empty
    read-only host array (a store mapping) bound for a CUDA device.
    Writeable arrays (pack buffers, layouts built per batch) and the CPU
    device keep the plain copy."""
    return device.type == "cuda" and not a.flags.writeable and a.nbytes > 0


def copy_into(dst: np.ndarray, a: np.ndarray, pool=None, parts: int = 1) -> None:
    """Copy `a` into the flat uint8 buffer `dst` (at least a.nbytes long)
    in C order, reading `a` only. A C-contiguous array from SPLIT bytes up
    is copied in `parts` slices, all but the last on `pool` (numpy's copy
    releases the interpreter lock)."""
    n = a.nbytes
    if not a.flags.c_contiguous:
        np.copyto(dst[:n].view(a.dtype).reshape(a.shape), a)
        return
    src = a.reshape(-1).view(np.uint8)
    if pool is None or parts < 2 or n < SPLIT:
        np.copyto(dst[:n], src)
        return
    cuts = [n * k // parts // ALIGN * ALIGN for k in range(parts)] + [n]
    futures = [pool.submit(np.copyto, dst[lo:hi], src[lo:hi])
               for lo, hi in zip(cuts[:-2], cuts[1:-1])]
    np.copyto(dst[cuts[-2]:n], src[cuts[-2]:])
    for f in futures:
        f.result()


class StagingRing:
    """Regions of one host buffer handed out in ring order, each held
    until the event recorded after the copy from it has completed.

    `alloc(nbytes)` gives a flat uint8 tensor; `allocations` counts its
    calls. `claim` returns the offset of a region of at least `nbytes`
    that no copy in flight reads; `release` hands the region to the copy
    that `event` follows."""

    def __init__(self, alloc):
        self._alloc = alloc
        self.buf: torch.Tensor | None = None
        self.allocations = 0
        self._head = 0
        self._live: collections.deque = collections.deque()  # (start, end, event), oldest first

    @property
    def capacity(self) -> int:
        return 0 if self.buf is None else self.buf.numel()

    def claim(self, nbytes: int) -> int:
        n = -(-nbytes // ALIGN) * ALIGN
        if 2 * n > self.capacity:
            self._wait(len(self._live))  # nothing reads the old buffer any more
            self.buf = None
            self.buf = self._alloc(max(MIN_RING, 1 << (2 * n - 1).bit_length()))
            self.allocations += 1
            self._head = 0
        start = self._head if self._head + n <= self.capacity else 0
        end = start + n
        # the newest region in flight that [start, end) overlaps, and all older ones
        overlap = [i for i, (s, e, _) in enumerate(self._live) if s < end and start < e]
        if overlap:
            self._wait(overlap[-1] + 1)
        self._head = end
        return start

    def release(self, start: int, nbytes: int, event) -> None:
        self._live.append((start, start + nbytes, event))

    def _wait(self, k: int) -> None:
        """Take back the k oldest regions, waiting for any copy from them
        still in flight (counter `pmnet.h2d_stage_waits`)."""
        for _ in range(k):
            event = self._live.popleft()[2]
            if not event.query():
                profiling.count("pmnet.h2d_stage_waits", 1)
                event.synchronize()


class PinnedStaging:
    """The page-locked ring of one screener on one card, and the copies
    from it on the screener's stream. The host memcpy uses up to `threads`
    threads (the screener's `pack_threads`)."""

    def __init__(self, device: torch.device, stream, threads: int = 1):
        self.device, self.stream = device, stream
        self.threads = max(1, int(threads))
        self.ring = StagingRing(self._pinned)
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._lock = threading.Lock()  # one claim-copy-release at a time

    def _pinned(self, nbytes: int) -> torch.Tensor:
        """A page-locked buffer (counter `pmnet.h2d_pinned_alloc_bytes`)."""
        profiling.count("pmnet.h2d_pinned_alloc_bytes", nbytes)
        with torch.cuda.device(self.device):
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def to_device(self, a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Read-only host array -> tensor on the card, through the ring (a
        `dtype` other than the array's is cast on the card).
        Spans `pmnet.dispatch.copy_out` (claim and memcpy into the ring)
        and `pmnet.dispatch.h2d` (the copy queued on the stream); counters
        `pmnet.copy_out_bytes` and `pmnet.h2d_staged_bytes`."""
        n = a.nbytes
        src_dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        with self._lock:
            with profiling.span("pmnet.dispatch.copy_out"):
                start = self.ring.claim(n)
                host = self.ring.buf[start:start + n]
                if self.threads > 1 and self._pool is None and n >= SPLIT:
                    self._pool = concurrent.futures.ThreadPoolExecutor(
                        self.threads - 1, thread_name_prefix="pinned-staging")
                copy_into(host.numpy(), a, self._pool, self.threads)
            profiling.count("pmnet.copy_out_bytes", n)
            with torch.cuda.stream(self.stream), profiling.span("pmnet.dispatch.h2d"):
                t = host.view(src_dtype).view(a.shape).to(self.device, dtype=dtype,
                                                          non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            self.ring.release(start, n, event)
        profiling.count("pmnet.h2d_staged_bytes", n)
        return t
