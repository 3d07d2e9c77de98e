"""CPU tests of the benchmark: its modules import as the harness imports
them (the benchmark's folder first on the path, the checkout after it)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELL = "tiny.stored-c4"


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's routes and metrics beside a BENCHMARK.json
    whose one cell screens a library of 192 ligands (64 distinct) x 4
    conformers in batches of 32, for runs of the harness on the CPU.
    Returns the copy's benchmark folder."""
    bench = tmp_path / "benchmark"
    for sub in ("routes", "metrics"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH_DIR / "configs" / "screen-pm20.json").read_text())
    config.update(name="tiny", batch_size=32, library_ligands=192, distinct_ligands=64,
                  host_threads=2)
    (bench / "configs" / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH_DIR / "traffic" / "stored-frag-c8.json").read_text())
    traffic.update(conformers=4, check_sample=96)
    (bench / "traffic" / "tiny-c4.json").write_text(json.dumps(traffic))
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="benchmark/configs/tiny.json")]
    spec["workloads"] = [dict(name=TINY_CELL, config="tiny", traffic="tiny-c4",
                              chips=1, why="tiny")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m["workloads"] = [TINY_CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
