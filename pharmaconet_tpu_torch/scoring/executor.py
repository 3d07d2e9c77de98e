"""Overlapped screening executor: pack workers feed the device in order.

Screening a library is three stages with different resources:

  pack   (C++ pack_tiled, releases the GIL)   host CPU, per batch
  device (K1, asynchronous launch)            the card
  tail   (pair compaction + prune + C++ DFS)  host CPU, per batch

This executor runs a small pool of pack workers ahead of the main thread,
which dispatches each batch to the screener's device (on the screener's
stream, whichever thread it runs on) and post-processes it while the next
batches pack. Each worker owns a private buffer cache (the packed arrays
alias it), gated by a one-slot semaphore released only after the batch's
results are back on the host — so buffers are never overwritten in flight.
Batch order, and therefore score order, is preserved exactly.
"""

from __future__ import annotations

import threading
from collections.abc import Sequence

from .batch_screen import BatchScreener, PackedLigand


class _PackWorker:
    def __init__(self) -> None:
        self.cache: dict = {}
        self.slot = threading.Semaphore(1)


class ScreeningExecutor:
    """Streams batches of prepacked ligands through the screener with the
    pack stage overlapped ahead of device dispatch + host postprocessing.

    Screeners that do not use the one-pass pack (K4, K5 or the reference
    engine) run their sequential path. Scores equal
    BatchScreener.score_packed exactly (tested)."""

    def __init__(
        self,
        screener: BatchScreener,
        batch_size: int = 2048,
        pack_workers: int = 2,
    ):
        assert pack_workers >= 1
        self.screener = screener
        self.batch_size = batch_size
        self.workers = [_PackWorker() for _ in range(pack_workers)]
        self._hint_lock = threading.Lock()

    def score_packed(
        self,
        packed: Sequence[PackedLigand],
        on_batch=None,
    ) -> list[float]:
        """on_batch(start_index, scores_list), called as each batch's
        results materialize (in order) — lets callers stream results to
        disk for crash recovery without losing the pack/device overlap."""
        from . import tiled_pack

        screener = self.screener
        batches = [
            packed[i : i + self.batch_size]
            for i in range(0, len(packed), self.batch_size)
        ]
        n_batches = len(batches)
        if n_batches == 0:
            return []
        if not screener.uses_tiled_pack or n_batches == 1:
            out: list[float] = []
            for bi, b in enumerate(batches):
                scores = screener.score_packed(list(b))
                if on_batch is not None:
                    on_batch(bi * self.batch_size, scores)
                out.extend(scores)
            return out

        packed_out: list[tuple] = [None] * n_batches  # (live_idx, tb | None)
        ready = [threading.Event() for _ in range(n_batches)]
        errors: list[BaseException] = []
        cancel = threading.Event()

        def pack_loop(worker: _PackWorker, first: int) -> None:
            for bi in range(first, n_batches, len(self.workers)):
                worker.slot.acquire()
                if cancel.is_set():
                    ready[bi].set()
                    return
                try:
                    batch = batches[bi]
                    live = [(i, p) for i, p in enumerate(batch) if p.clusters]
                    tb = None
                    if live:
                        tb = tiled_pack.build_tiled_batch(
                            screener.packed_model, [p for _, p in live],
                            threads=1,
                            rows_hint=int(screener._rows_hint * len(live)),
                            buffer_cache=worker.cache,
                        )
                        # learn the rows-per-ligand estimate so later
                        # batches size their first allocation right;
                        # locked: the moving average is a read-modify-
                        # write shared across pack workers
                        with self._hint_lock:
                            screener._rows_hint = (
                                0.7 * screener._rows_hint
                                + 0.3 * (tb.nst / max(1, len(live)))
                            )
                    packed_out[bi] = (live, tb)
                except BaseException as e:  # surface in the main thread
                    errors.append(e)
                    packed_out[bi] = (None, None)
                finally:
                    ready[bi].set()

        threads = [
            threading.Thread(target=pack_loop, args=(w, k), daemon=True)
            for k, w in enumerate(self.workers)
        ]
        for t in threads:
            t.start()

        out = []
        consumed = 0
        try:
            for bi in range(n_batches):
                ready[bi].wait()
                if errors:
                    raise errors[0]
                live, tb = packed_out[bi]
                scores = [0.0] * len(batches[bi])
                if live:
                    for (i, _), s in zip(live, screener.score_tb(tb)):
                        scores[i] = s
                if on_batch is not None:
                    on_batch(bi * self.batch_size, scores)
                out.extend(scores)
                # results are on the host — the worker may reuse its buffers
                self.workers[bi % len(self.workers)].slot.release()
                consumed = bi + 1
        finally:
            # on error, unblock every worker so threads exit instead of
            # parking forever on slot.acquire() with their caches pinned
            if consumed < n_batches:
                cancel.set()
                for w in self.workers:
                    w.slot.release()
            for t in threads:
                t.join()
        return out
