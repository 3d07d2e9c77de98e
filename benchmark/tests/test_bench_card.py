"""One short run of each cell on the card (marked gpu; skips without one):
a result line with `correct` true, the cell's end-to-end metrics, and the
per-layer ones with a trace.

  python -m pytest -m gpu benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

import harness
from conftest import BENCH_DIR, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in spec["workloads"]:
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell["name"], "--seed",
             str(2**31 + 7), "--seconds", "2", "--trace", str(trace)],
            capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-4000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], out.stderr[-2000:]
        want = {m["name"] for m in harness.cell_metrics(spec, cell["name"], bool(trace))}
        assert set(result["metrics"]) == want
        assert result["device"]["platform"] == "gpu"
        assert (BENCH_DIR / "metrics").is_dir()
