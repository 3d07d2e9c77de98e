"""Readings of the modeling cell's `correct` on several seeds in one
process: the program as the configuration states it (float32), and its
control, the program with its own TF32 path switched on
(`PharmacoNet(matmul_precision="tensorfloat32")`: the trunk's and heads'
products and convolutions in TF32, the precision below float32). The
control has to fail at least one of the cell's checks on every seed; the
sound readings set the limits' lower ends.

  python3 benchmark/detector_control.py --workload detector.pocket3k-p8 \\
      --precision tensorfloat32 --seeds 1 2 3

Each seed runs the route's set-up (its warm pass models every pocket, as
the window's passes do) and the route's check on that pass. Prints one
line per seed and a JSON summary last. Needs a CUDA device unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "cuda"))
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def readings(bench_dir: Path, workload: str, seeds: list[int], precision: str,
             device: str) -> dict[int, dict]:
    """Per seed: each check's value, the raw readings and the set-up's
    seconds, of the route's check on its warm pass."""
    import torch

    found = harness.find_cell(bench_dir, workload)
    module = harness.load_module(found.route, f"route_{found.traffic['route']}")
    out = {}
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="bench-control-") as work_dir:
            ctx = SimpleNamespace(config=found.config, traffic=found.traffic, seed=seed,
                                  device=device, work_dir=work_dir, root=harness.CHECKOUT,
                                  precision=precision)
            route = module.Route(ctx)
            t0 = time.perf_counter()
            route.setup()
            setup_s = time.perf_counter() - t0
            route.free()
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
            checks, _, failed = route.check([route.items_per_pass])
            out[seed] = dict(checks={n: v for n, v, _ in checks},
                             correct=all(v <= lim for _, v, lim in checks), failed=failed,
                             readings=route.readings, setup_s=setup_s)
    return out


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser("detector_control")
    parser.add_argument("--workload", default="detector.pocket3k-p8")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", default="tensorfloat32",
                        choices=("float32", "tensorfloat32"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    got = readings(BENCH_DIR, args.workload, args.seeds, args.precision, args.device)
    for seed, r in got.items():
        print(f"control {args.workload} seed {seed} {args.precision} correct {r['correct']} "
              + " ".join(f"{n} {v}" for n, v in r["checks"].items())
              + f" readings {json.dumps(r['readings'])}", flush=True)
    print(json.dumps({"workload": args.workload, "precision": args.precision,
                      "device": args.device, "seeds": got}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
