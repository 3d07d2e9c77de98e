"""Profiling hooks (`pharmaconet_tpu/utils/profiling.py`):

  * ``trace(log_dir)``: a `torch.profiler` trace of the block, written to
    `log_dir` as a Chrome trace (`*.pt.trace.json`) that TensorBoard's
    profiler plugin and Perfetto read, with the block's spans and counts
    beside it (`*.pmnet.json`);
  * ``span(name, batch=None)`` and ``count(name, n)``: host spans and
    counters inside the program (`pmnet.*`), recorded only while
    `torch.profiler` records;
  * ``spans()``, ``counts()`` and ``clear()``: what was recorded.

A span records its name, its start and end, its thread, its parent (the
innermost span open on the same thread when it began) and the batch index
it belongs to (`bi`: its own `batch`, else its parent's), so that every
span of one batch carries the same index. Start and end are epoch
nanoseconds (`time.time_ns`), the clock of `torch.profiler`'s events, so
a span lies on the profiler's timeline beside the card's kernels and
copies; each recorded span is also a `record_function` range, and shows
by name in the Chrome trace of the thread that started the profiler
(torch.profiler follows that thread alone; the store's prefetch thread
records its spans here all the same). With no profiler recording, `span`
returns a shared null context after one flag check and `count` adds
nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    """True while torch.profiler records, on any thread: the profiler sets
    this flag for the whole process, where `torch._C._autograd.
    _profiler_enabled()` is true only on the thread that started it."""
    return torch.autograd.profiler._is_profiler_enabled


class Recorder:
    """Spans and counts in memory (thread-safe: the store's prefetch
    thread records too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = threading.local()  # per thread: the stack of open spans
        self._ids = itertools.count()
        self._spans: list[dict] = []
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, batch: int | None = None):
        from torch.profiler import record_function

        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        parent = stack[-1] if stack else None
        if batch is None and parent is not None:
            batch = parent["bi"]
        rec = dict(id=next(self._ids), name=name, parent=parent["id"] if parent else None,
                   thread=threading.current_thread().name, bi=batch, start=time.time_ns())
        stack.append(rec)
        try:
            with record_function(name):
                yield
        finally:
            rec["end"] = time.time_ns()
            stack.pop()
            with self._lock:
                self._spans.append(rec)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] += int(n)

    def spans(self) -> list[dict]:
        """The finished spans, in the order they began."""
        with self._lock:
            return sorted((dict(s) for s in self._spans), key=lambda s: (s["start"], s["id"]))

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()


_recorder = Recorder()  # the process's: torch.profiler, which gates it, is process-wide too


def span(name: str, batch: int | None = None):
    """A span around the block while torch.profiler records, else a no-op."""
    return _recorder.span(name, batch) if _profiling() else _NULL


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` while torch.profiler records."""
    if _profiling():
        _recorder.count(name, n)


def spans() -> list[dict]:
    return _recorder.spans()


def counts() -> dict[str, int]:
    return _recorder.counts()


def clear() -> None:
    _recorder.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler into `log_dir`: host activity,
    and the card's kernels and copies when torch sees a CUDA device. The
    Chrome trace is `<host>_<pid>.<ns>.pt.trace.json`; the block's spans
    and counts go beside it as `<host>_<pid>.<ns>.pmnet.json`
    ({"spans": [...], "counts": {...}})."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        stem = out / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
        prof.export_chrome_trace(f"{stem}.pt.trace.json")
        Path(f"{stem}.pmnet.json").write_text(json.dumps(dict(spans=spans(), counts=counts())))

    clear()
    with profile(activities=activities, on_trace_ready=write):
        yield
