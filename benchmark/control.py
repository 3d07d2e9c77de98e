"""The control of a cell's `correct`: its plain reference computed in the
nearest precision below the configuration's (bfloat16 for its float32),
put in the program's place on the sample a run compares, on each seed.
It has to read above the limit that sound runs stay under.

  python3 benchmark/control.py --workload pm20.stored-c8 --seeds 1 2 3

Prints one line per seed and a JSON summary last. Needs neither a card nor
the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

import harness  # noqa: E402


def control_readings(bench_dir: Path, workload: str, seeds: list[int]) -> dict[int, float]:
    found = harness.find_cell(bench_dir, workload)
    module = harness.load_module(found.route, f"route_{found.traffic['route']}")
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench-control-") as work_dir:
        for seed in seeds:
            ctx = SimpleNamespace(config=found.config, traffic=found.traffic, seed=seed,
                                  device="cpu", work_dir=work_dir, root=harness.CHECKOUT)
            out[seed] = module.Route(ctx).control()
    return out


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser("control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    readings = control_readings(BENCH_DIR, args.workload, args.seeds)
    for seed, value in readings.items():
        print(f"control {args.workload} seed {seed} bfloat16 score_tol_share {value}")
    print(json.dumps({"workload": args.workload, "precision": "bfloat16",
                      "score_tol_share": readings,
                      "least": min(readings.values())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
