"""The program's own spans, read after a traced window.

`pharmaconet_tpu_torch.utils.profiling` records spans (`pmnet.*`) inside
the program while torch.profiler records: name, start and end in epoch
nanoseconds (the clock of the profiler's events, and so of
`records["timeline"]`), thread, parent span and batch index. The readers
here clip them to the window's `bench.window` bounds and take the card's
busy time from the timeline's device events. A program without that
recorder (one older than its spans), or a window in which it recorded no
`pmnet.dispatch`, reads None, and the metric is left out of the line.
"""

from __future__ import annotations

from collections import defaultdict

import device_trace

DISPATCH = "pmnet.dispatch"  # one per batch, on the thread that screens


def window_spans(records) -> tuple[list[dict], tuple[int, int]] | None:
    """(the program's spans clipped to the window, the window's bounds)."""
    tl = records.get("timeline")
    w = device_trace.window_bounds(tl) if tl else None
    if w is None:
        return None
    try:
        from pharmaconet_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    spans = [dict(s, start=max(s["start"], w[0]), end=min(s["end"], w[1]))
             for s in profiling.spans() if s["end"] > w[0] and s["start"] < w[1]]
    if not any(s["name"] == DISPATCH for s in spans):
        return None
    return spans, w


def per_batch_ms(records, name: str) -> float | None:
    """Host ms in spans `name` over the window, per batch dispatched."""
    got = window_spans(records)
    if got is None:
        return None
    spans, _ = got
    batches = sum(s["name"] == DISPATCH for s in spans)
    return sum(s["end"] - s["start"] for s in spans if s["name"] == name) / batches / 1e6


def self_ms(records, name: str) -> float | None:
    """Self ms per batch of spans `name`: each one's time less the part of
    it that its child spans cover."""
    got = window_spans(records)
    if got is None:
        return None
    spans, _ = got
    children = defaultdict(list)
    for s in spans:
        children[s["parent"]].append((s["start"], s["end"]))
    total, batches = 0, 0
    for s in spans:
        if s["name"] == name:
            covered = device_trace.union(children[s["id"]], s["start"], s["end"])
            total += s["end"] - s["start"] - sum(e - b for b, e in covered)
        batches += s["name"] == DISPATCH
    return total / batches / 1e6


def _overlap_ns(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """Nanoseconds common to two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(records, names) -> float | None:
    """Percent of the window in which the card runs neither a kernel nor a
    copy while the screening thread (the one that dispatches) is inside a
    span named in `names`."""
    got = window_spans(records)
    tl = records.get("timeline")
    if got is None or not tl["device"]:
        return None
    spans, w = got
    busy = device_trace.union([(s, e) for _, s, e, _ in tl["device"]], *w)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    main = next(s["thread"] for s in spans if s["name"] == DISPATCH)
    inside = device_trace.union([(s["start"], s["end"]) for s in spans
                                 if s["name"] in names and s["thread"] == main], *w)
    return 100.0 * _overlap_ns(idle, inside) / (w[1] - w[0])
