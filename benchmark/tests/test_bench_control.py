"""The control of `correct`: the reference in bfloat16 put in the
program's place reads far above the limit that sound runs stay under."""

import control
from conftest import TINY_CELL


def test_the_control_fails_the_limit(tiny_bench):
    readings = control.control_readings(tiny_bench, TINY_CELL, [1, 2, 3])
    assert len(readings) == 3
    assert min(readings.values()) > 3.0  # the limit is 1
