"""One screen, one CSV: the stored route screened in fresh processes, and
the first call of MKL's vector math in a process that has imported the
port.

On the CPU torch computes exp, sqrt, log, tanh and their kin with MKL's
vector math, which sets itself up lazily on the first call in a process.
When that call runs on several OpenMP threads at once, the threads that
arrive during the set-up compute their whole share about 1.5e-4 relative
off, so a CPU screen's first batch could differ from one fresh process to
the next. Importing the port now sets the vector math up on one thread
(`device.set_up_cpu_vector_math`).

- The screening CLI on the battery's v3 store (`chip_ci.write_battery_store`,
  256 ligands) runs in RUNS fresh processes, forked from one interpreter
  that has imported the port and made no other torch call
  (`probe_reproducible.fork_screens`): each run's first plain Gaussian
  phase is the first large vector-math call of its process, on every
  thread torch has. Every CSV must be byte-identical.
- Each vector-math function's first call, on 2^20 float32 and every
  thread, in FIRST_CALL_RUNS processes forked from an interpreter that has
  imported the port (`probe_reproducible.first_calls`): none may be off.
The race hits about 1-3% of fresh processes, so without the set-up these
tests fail on most runs, not all; with it they pass on every run.
"""

from __future__ import annotations

import pytest
import torch

from pharmaconet_tpu_torch.probes import chip_ci
from pharmaconet_tpu_torch.probes.probe_reproducible import (
    FIRST_CALL_OPS,
    first_calls,
    fork_screens,
    summarize,
)

RUNS = 16
FIRST_CALL_RUNS = 48


def test_stored_screen_gives_one_csv_in_fresh_processes(tmp_path):
    model = chip_ci.battery_model()
    model.save(str(tmp_path / "model.pm"))
    chip_ci.write_battery_store(tmp_path / "tiles", model, torch.device("cpu"))
    s = summarize(fork_screens(tmp_path / "model.pm", tmp_path / "tiles", tmp_path / "runs",
                               RUNS, "cpu"))
    assert s["rows"] == 256
    assert s["distinct_csvs"] == 1, (
        f"{s['distinct_csvs']} different CSVs in {RUNS} fresh processes: {s['differing_runs']}")


@pytest.mark.parametrize("op", sorted(FIRST_CALL_OPS))
def test_first_vector_math_call_after_importing_the_port(op):
    bad = first_calls("port", FIRST_CALL_RUNS, {op: FIRST_CALL_OPS[op]})
    assert bad == {op: 0}, f"torch.{op}'s first call was off in {bad[op]} of " \
                           f"{FIRST_CALL_RUNS} fresh processes"
