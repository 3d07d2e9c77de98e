"""Run one cell of the benchmark of `pharmaconet_tpu_torch` on this machine.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output, and each number compared for `correct` beside its limit
as the last lines of standard error. Exits 3, printing no result, where
the cell's CUDA devices are not visible, and 4 where JAX or the JAX
package was loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up is timed from here

from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]  # the harness, then the program

import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], T0))
