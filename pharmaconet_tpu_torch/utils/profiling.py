"""Profiling hooks (`pharmaconet_tpu/utils/profiling.py`):

  * ``trace(log_dir)``: a `torch.profiler` trace of the block, written to
    `log_dir` as a Chrome trace (`*.pt.trace.json`) that TensorBoard's
    profiler plugin and Perfetto read;
  * ``StageTimer``: wall-clock time per named host stage, with a report.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler into `log_dir`: host activity,
    and the card's kernels and copies when torch sees a CUDA device."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StageTimer:
    """Accumulates wall-clock time per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name}: {total:.3f}s total, {total / n * 1e3:.1f} ms/call ({n} calls)")
        return "\n".join(lines)
