"""The traced run's records: host spans timed around the program's calls,
and the card's timeline from `torch.profiler`.

Spans are named `bench.<layer>`. Each is timed on the host clock (its
durations feed the per-layer means) and marked with `record_function`, so
that it lies on the profiler's timeline beside the card's kernels and
copies and can label the card's idle gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import defaultdict

# what the main thread was in during an idle gap, by span; outside any
# span it was writing the partial CSV or starting a pass
GAP_LABELS = {
    "bench.wait": "store load (main thread waits for the prefetch thread)",
    "bench.dispatch": "dispatch (copy and launch)",
    "bench.tail": "tail (wait for the card, outlier DFS)",
}
OTHER_HOST = "CSV write and pass start"


class Recorder:
    """Host spans of one traced window (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.durations: dict[str, list[float]] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] += n

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.durations[name].append(dt)


def _annotation(evt) -> bool:
    """A user annotation mirrored onto the card's timeline: no device work."""
    flag = getattr(evt, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def timeline(prof) -> dict:
    """The profiler's events as plain lists (times in ns, one base):
    device events [(name, start, end, is_copy)], host spans
    [(name, start, end)] of the `bench.*` annotations."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = int(e.start_ns()), int(e.duration_ns())
        name = e.name()
        if name.startswith("bench."):  # on the host and, mirrored, the card's row
            if not str(e.device_type()).endswith("CUDA"):
                spans.append((name, start, start + dur))
        elif str(e.device_type()).endswith("CUDA") and not _annotation(e):
            is_copy = name.startswith(("Memcpy", "Memset"))
            device.append((name, start, start + dur, is_copy))
    return {"device": device, "spans": spans}


def union(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """Merged intervals, clipped to [lo, hi]."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def window_bounds(tl: dict) -> tuple[int, int] | None:
    w = [(s, e) for n, s, e in tl["spans"] if n == "bench.window"]
    return w[0] if w else None


def busy_ns(tl: dict) -> int | None:
    """Nanoseconds of the window with a kernel or a copy on the card."""
    w = window_bounds(tl)
    if w is None or not tl["device"]:
        return None
    return sum(e - s for s, e in union([(s, e) for _, s, e, _ in tl["device"]], *w))


def idle_gaps(tl: dict) -> list[tuple[str, float]]:
    """Idle seconds of the card in the window, summed by what the main
    thread was in at each gap's middle, longest first."""
    w = window_bounds(tl)
    if w is None or not tl["device"]:
        return []
    busy = union([(s, e) for _, s, e, _ in tl["device"]], *w)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    main = sorted((s, e, n) for n, s, e in tl["spans"] if n in GAP_LABELS)
    starts = [s for s, _, _ in main]
    totals: dict[str, float] = defaultdict(float)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        label = OTHER_HOST
        i = bisect.bisect_right(starts, mid) - 1
        # spans of the main thread do not overlap; the latest that began
        # before the middle holds it if it has not ended
        if i >= 0 and main[i][1] >= mid:
            label = GAP_LABELS[main[i][2]]
        totals[label] += (g1 - g0) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])


def top_ops(tl: dict, k: int = 10) -> list[tuple[str, float]]:
    """Device seconds by kernel or copy name inside the window, most first."""
    w = window_bounds(tl)
    totals: dict[str, float] = defaultdict(float)
    for name, s, e, _ in tl["device"]:
        if w is not None:
            s, e = max(s, w[0]), min(e, w[1])
        if e > s:
            totals[name] += (e - s) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]
