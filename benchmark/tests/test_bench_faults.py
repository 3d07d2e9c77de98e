"""`correct` comes out false when the timed path is broken underneath: a
step that hands back the previous batch's state, half of each batch left
out, an answer altered where it is produced, NaN answers in library order. The harness runs on the CPU
here (its look for a card skipped), the rest of a run as on the card."""

import time

import numpy as np
import pytest

import harness
from conftest import TINY_CELL
from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener


def _stale():
    last = {}

    def post(self, sb, result):
        scores = POST(self, sb, result)
        prev = last.get(id(self), [0.0] * len(scores))
        last[id(self)] = scores
        return prev[: len(scores)] + [0.0] * (len(scores) - len(prev))
    return post


def _half():
    def post(self, sb, result):
        scores = POST(self, sb, result)
        keep = scores[: len(scores) // 2]
        mean = float(np.mean(keep)) if keep else 0.0
        return keep + [mean] * (len(scores) - len(keep))
    return post


def _altered():
    def post(self, sb, result):
        scores = POST(self, sb, result)
        scores[len(scores) // 3] += 1e-2 * abs(scores[len(scores) // 3]) + 1e-2
        return scores
    return post


def _nan():
    def post(self, sb, result):
        scores = POST(self, sb, result)
        return [float("nan")] * len(scores)
    return post


def _one_nan():
    def post(self, sb, result):
        scores = POST(self, sb, result)
        return [float("nan") if j % 7 == 3 else s for j, s in enumerate(scores)]
    return post


POST = BatchScreener.postprocess_stored


@pytest.mark.parametrize("fault", [None, _stale, _half, _altered, _nan, _one_nan],
                         ids=["sound", "stale", "half", "altered", "nan", "some_nan"])
def test_a_broken_path_is_not_correct(tiny_bench, monkeypatch, fault):
    if fault is not None:
        monkeypatch.setattr(BatchScreener, "postprocess_stored", fault())
    result, lines = harness.run_cell(tiny_bench, TINY_CELL, 99, 0.2, False, "cpu",
                                     time.perf_counter())
    assert result["correct"] is (fault is None), lines
    assert (result["failed"] > 0) is (fault is not None)
