"""The control of the modeling cell's `correct` on the card (marked gpu;
skips without one), at the small size: the program with its TF32 path on
fails at least one check on every seed, the program as configured passes.

  python -m pytest -m gpu benchmark/tests/test_bench_detector_card.py
"""

import pytest

import detector_control
from detector_cells import TINY_DETECTOR, make_tiny_detector


@pytest.mark.gpu
def test_the_tf32_control_is_not_correct(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = make_tiny_detector(tmp_path)
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    sound = detector_control.readings(bench, TINY_DETECTOR, seeds, "float32", "cuda")
    control = detector_control.readings(bench, TINY_DETECTOR, seeds, "tensorfloat32", "cuda")
    assert all(r["correct"] for r in sound.values()), sound
    assert not any(r["correct"] for r in control.values()), control
