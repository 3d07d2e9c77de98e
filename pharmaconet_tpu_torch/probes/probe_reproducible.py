"""Does one screen give one CSV? The screening CLI on one tile store, run in
many fresh processes, with every per-batch array of the stored route
hashed stage by stage; and the first call of MKL's vector math in fresh
processes.

    python -m pharmaconet_tpu_torch.probes.probe_reproducible [--device cuda|cpu]
        [--runs 32] [--conditions default,threads1,...] [--dump] [--first_calls N]

The battery's model and v3 store (`chip_ci.battery_model`,
`chip_ci.write_battery_store`: 256 synthetic ligands in batches of 128,
leaves baked) go to a temporary directory. Per condition one fresh
interpreter imports the port (which sets up the CPU's vector math,
`device.set_up_cpu_vector_math`) and forks `--runs` children
(`fork_screens`). Each child sets its one condition, runs
`cli.screening.main` on the store with `--device`, and writes its CSV: a
screen started from the shell, in its own process, many of them in
seconds, not minutes.

Conditions, one changed at a time against `default` (the CLI as a user
runs it):
  threads1      torch.set_num_threads(1)
  prefetch0     the store's batches loaded on the main thread, no prefetch
                thread (TiledStore.iter_loaded replaced by a plain loop)
  cold_build    pharmaconet_tpu_torch.native.BUILD_DIR pointed at an empty
                directory, so any native or CUDA library builds anew
  mkl_dynamic   MKL_DYNAMIC=FALSE in the interpreter's environment
  mkl_cbwr      MKL_CBWR=COMPATIBLE (MKL's one code path for every CPU)
  numpy_first   the interpreter imports numpy before torch and the port

With `--dump` each child also hashes (SHA-1 of the bytes) every array of
each stage, per batch, in call order:
  load        the StoredV3Batch arrays of TiledStore.load (prefetch thread)
  to_device   each BatchScreener._to_device output
  exp         every torch.exp (the plain Gaussian phase's), and its
              largest error relative to numpy's float64 exp
  gauss       K2's plain Gaussian phase (screen_ref.gauss_phase_dt)
  k2          K2's output (screen_cuda.score_tiles_v3_rows)
  leaf_S      the leaf chain's first product per bucket (torch.bmm)
  leaf_D      its second product per bucket (torch.bmm)
  epilogue    leaf_tree._bucket_epilogue
  scores      BatchScreener.postprocess_stored
Runs whose CSV differs from the most common one are named with the
ligands whose scores differ, the largest relative difference, whether the
ranked order moved, the first stage whose hashes differ and, per stage,
the calls that differ.

`--first_calls N` (on the CPU, whatever `--device`; `--runs 0` skips the
screens): per setup of FIRST_CALL_SETUPS, one interpreter imports torch
and numpy, then does nothing more ("none"), imports the port ("port"), or
calls one vector-math function on 16 elements ("exp", "sqrt", "log",
"tanh"), and forks N children per function of FIRST_CALL_OPS; each
child's first call of that function runs on 2^20 float32 on 32 threads
and is checked against numpy's float64 result (`first_calls`). The count
of children more than FIRST_CALL_REL off shows the race ("none") and its
repair. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CONDITIONS = ("default", "threads1", "prefetch0", "cold_build", "mkl_dynamic", "mkl_cbwr",
              "numpy_first")
ENV_CONDITIONS = {"mkl_dynamic": {"MKL_DYNAMIC": "FALSE"}, "mkl_cbwr": {"MKL_CBWR": "COMPATIBLE"}}
STAGES = ("load", "to_device", "exp", "gauss", "k2", "leaf_S", "leaf_D", "epilogue", "scores")


# --------------------------------------------------------------------------
# The parent side
# --------------------------------------------------------------------------
def fork_screens(model_path: Path, store_dir: Path, out_dir: Path, runs: int, device: str,
                 condition: str = "default", dump: bool = False,
                 timeout: float = 900.0) -> list[dict]:
    """`runs` screens of the store by the CLI on `device`, each in a
    process forked from one fresh interpreter that has imported the port
    and made no other torch call. Returns per run
    {"csv": bytes, "stages": {stage: [hash, ...]} or None}. Raises if a run
    fails."""
    if condition not in CONDITIONS:
        raise ValueError(f"unknown condition {condition!r}; expected one of {CONDITIONS}")
    out_dir.mkdir(parents=True, exist_ok=True)
    module = "pharmaconet_tpu_torch.probes.probe_reproducible"
    zygote = ["--zygote", "--model", str(model_path), "--store", str(store_dir), "--out",
              str(out_dir), "--runs", str(runs), "--device", device, "--conditions", condition,
              *(["--dump"] if dump else [])]
    if condition == "numpy_first":
        cmd = [sys.executable, "-c", "import numpy, runpy, sys; sys.argv[1:] = "
               f"{zygote!r}; runpy.run_module({module!r}, run_name='__main__')"]
    else:
        cmd = [sys.executable, "-m", module, *zygote]
    env = {**os.environ, **ENV_CONDITIONS.get(condition, {})}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{condition}: the screens failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    results = []
    for k in range(runs):
        stages = out_dir / f"run{k:03d}.json"
        results.append({"csv": (out_dir / f"run{k:03d}.csv").read_bytes(),
                         "stages": json.loads(stages.read_text()) if dump else None})
    return results


def csv_scores(csv: bytes) -> list[tuple[str, float]]:
    """(name, score) rows of a screening CSV, header dropped."""
    rows = []
    for line in csv.decode().splitlines()[1:]:
        name, score = line.rsplit(",", 1)
        rows.append((name, float(score)))
    return rows


def csv_difference(got: bytes, want: bytes) -> dict:
    """Ligands whose score in `got` differs from `want`, their largest
    relative difference, and whether the ranked order differs (the CSV is
    sorted by score, so a moved score can move rows)."""
    a, b = dict(csv_scores(got)), dict(csv_scores(want))
    if a.keys() != b.keys():
        return {"rows": len(a.keys() ^ b.keys()), "max_rel": float("inf"), "order_differs": True}
    diff = [(a[n], b[n]) for n in b if a[n] != b[n]]
    rel = max((abs(x - y) / max(abs(y), 1e-30) for x, y in diff), default=0.0)
    return {"rows": len(diff), "max_rel": rel,
            "order_differs": [n for n, _ in csv_scores(got)] != [n for n, _ in csv_scores(want)]}


def differing_calls(got: dict, want: dict) -> dict[str, list[int]]:
    """Per stage, in pipeline order, the calls whose hashes differ (a
    missing or extra call counts as differing)."""
    out = {}
    for stage in STAGES:
        a, b = got.get(stage, []), want.get(stage, [])
        calls = [i for i in range(max(len(a), len(b)))
                 if i >= len(a) or i >= len(b) or a[i] != b[i]]
        if calls:
            out[stage] = calls
    return out


def summarize(results: list[dict]) -> dict:
    """Distinct CSVs among the runs; each run that differs from the most
    common CSV with its rows, relative difference and first stage."""
    counts = Counter(r["csv"] for r in results)
    common = counts.most_common(1)[0][0]
    ref = next(r for r in results if r["csv"] == common)
    differing = []
    for k, r in enumerate(results):
        if r["csv"] != common:
            d = csv_difference(r["csv"], common)
            if r["stages"] is not None:
                d["differing_calls"] = differing_calls(r["stages"], ref["stages"])
                d["first_stage"] = next(iter(d["differing_calls"]), None)
                d["exp_max_rel_err"] = max(r["stages"].get("exp_max_rel_err", [0.0]))
            differing.append({"run": k, **d})
    out = {"runs": len(results), "distinct_csvs": len(counts),
           "rows": len(csv_scores(common)), "differing_runs": differing}
    if ref["stages"] is not None:  # the most common CSV's runs
        out["exp_max_rel_err"] = max(max(r["stages"].get("exp_max_rel_err", [0.0]))
                                     for r in results if r["csv"] == common)
    return out


# --------------------------------------------------------------------------
# The zygote and its children
# --------------------------------------------------------------------------
def _digest(value) -> str | None:
    import hashlib

    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        return hashlib.sha1(np.ascontiguousarray(value).tobytes()).hexdigest()[:12]
    if isinstance(value, (list, tuple)) and all(isinstance(v, (int, float)) for v in value):
        return _digest(np.asarray(value, dtype=np.float64))
    if isinstance(value, (list, tuple)):
        parts = [_digest(v) for v in value]
        return hashlib.sha1(repr(parts).encode()).hexdigest()[:12]
    if hasattr(value, "__dict__"):  # a stored batch: its arrays by field name
        parts = sorted((k, _digest(v)) for k, v in vars(value).items())
        return hashlib.sha1(repr(parts).encode()).hexdigest()[:12]
    return None


def _install_dump(records: dict) -> None:
    """Wrap each stage's function so that its result's hash is appended to
    records[stage] (list.append is atomic: the prefetch thread's loads
    keep their own order)."""
    import numpy as np
    import torch

    from ..ops import screen_cuda, screen_ref
    from ..scoring import batch_screen, leaf_tree, tiled_store

    def wrap(owner, name: str, stage):
        fn = getattr(owner, name)

        def hooked(*args, **kwargs):
            out = fn(*args, **kwargs)
            records.setdefault(stage() if callable(stage) else stage, []).append(_digest(out))
            return out

        setattr(owner, name, hooked)

    wrap(tiled_store.TiledStore, "load", "load")
    wrap(batch_screen.BatchScreener, "_to_device", "to_device")
    exp = torch.exp

    def checked_exp(x):
        out = exp(x)
        want = np.exp(x.detach().cpu().numpy().astype(np.float64))
        err = np.abs(out.detach().cpu().numpy() - want) / np.maximum(want, 1e-30)
        records.setdefault("exp_max_rel_err", []).append(float(err.max(initial=0.0)))
        return out

    torch.exp = checked_exp
    wrap(torch, "exp", "exp")
    wrap(screen_ref, "gauss_phase_dt", "gauss")
    wrap(screen_cuda, "score_tiles_v3_rows", "k2")
    products = [0]

    def product_stage() -> str:  # S, then D, in every bucket
        products[0] += 1
        return "leaf_S" if products[0] % 2 else "leaf_D"

    wrap(torch, "bmm", product_stage)
    wrap(leaf_tree, "_bucket_epilogue", "epilogue")
    wrap(batch_screen.BatchScreener, "postprocess_stored", "scores")


def _apply(condition: str) -> None:
    """Set one child's condition, before anything of the screen runs."""
    import torch

    if condition == "threads1":
        torch.set_num_threads(1)
    elif condition == "prefetch0":
        from ..scoring import tiled_store

        def iter_loaded(self, indices, prefetch: int = 2, mmap: bool = True):
            for bi in indices:
                b = self.load(bi, mmap=mmap)
                tiled_store._page_in(b)
                yield bi, b

        tiled_store.TiledStore.iter_loaded = iter_loaded
    elif condition == "cold_build":
        from .. import native

        native.BUILD_DIR = Path(tempfile.mkdtemp(prefix="probe_build_"))


def _child(args, k: int) -> int:
    out = Path(args.out)
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 1)
    try:
        _apply(args.conditions)
        records: dict = {}
        if args.dump:
            _install_dump(records)
        from ..cli import screening

        rc = screening.main(screening.build_parser().parse_args(
            ["-p", args.model, "--library_tiles", args.store, "-o",
             str(out / f"run{k:03d}.csv"), "--device", args.device]))
        if args.dump:
            (out / f"run{k:03d}.json").write_text(json.dumps(records))
        return rc
    except BaseException:  # noqa: BLE001 - reported to the zygote through the file
        (out / f"run{k:03d}.err").write_text(traceback.format_exc())
        return 1


def zygote(args) -> int:
    """Fork one child per run, one after the other; the zygote itself has
    imported the port and made no other torch call."""
    import torch  # noqa: F401 - imported once here, inherited by every child

    from ..cli import screening  # noqa: F401

    Path(args.out).mkdir(parents=True, exist_ok=True)
    failed = []
    for k in range(args.runs):
        pid = os.fork()
        if pid == 0:  # the child never returns into this loop
            rc = 1
            try:
                rc = _child(args, k)
            finally:
                os._exit(rc)
        _, status = os.waitpid(pid, 0)
        if status != 0:
            err = Path(args.out) / f"run{k:03d}.err"
            failed.append(f"run {k}: status {status}\n"
                          f"{err.read_text() if err.exists() else ''}")
    if failed:
        print("\n".join(failed), file=sys.stderr)
        return 1
    return 0


# --------------------------------------------------------------------------
# First calls of MKL's vector math
# --------------------------------------------------------------------------
FIRST_CALL_OPS = {"exp": (-10.0, 0.0), "sqrt": (0.01, 10.0), "log": (0.01, 10.0),
                  "tanh": (-3.0, 3.0)}  # torch.<op> and its inputs' range
FIRST_CALL_SETUPS = ("none", "port", *FIRST_CALL_OPS)
FIRST_CALL_SIZE = 1 << 20  # far above torch's parallel grain: every thread takes a share
FIRST_CALL_THREADS = 32  # more threads meet the set-up: 2-7% of processes off, not 1-2% at 8
FIRST_CALL_REL = 1e-6  # MKL's HA mode is within 1 ulp (6e-8); a mid-set-up share is 1.5e-4 off

# Run by `python -c` so that "none" imports torch and numpy only, not the port.
_FIRST_CALL_ZYGOTE = """
import json, os, sys
import numpy as np
import torch
setup, runs, size, threads, rel, ops = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    int(sys.argv[4]), float(sys.argv[5]), json.loads(sys.argv[6])
if setup == "port":
    import pharmaconet_tpu_torch
elif setup != "none":
    getattr(torch, setup)(torch.ones(16))
bad = {}
for op, (lo, hi) in ops.items():
    x = np.random.default_rng(0).uniform(lo, hi, size).astype(np.float32)
    bad[op] = 0
    for _ in range(runs):
        pid = os.fork()
        if pid == 0:
            code = 2
            try:
                torch.set_num_threads(threads)
                got = getattr(torch, op)(torch.from_numpy(x)).numpy()
                want = getattr(np, op)(x.astype(np.float64))
                code = int((np.abs(got - want) / np.abs(want)).max() > rel)
                if len(os.listdir("/proc/self/task")) < threads:
                    code = 3
            finally:
                os._exit(code)
        code = os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])
        if code == 3:
            raise SystemExit(f"a child computed {op} on fewer than {threads} threads")
        if code not in (0, 1):
            raise SystemExit(f"a child computing {op} ended with {code}")
        bad[op] += code
print(json.dumps(bad))
"""


def first_calls(setup: str, runs: int, ops: dict = FIRST_CALL_OPS) -> dict[str, int]:
    """Per op of `ops`, how many of `runs` fresh processes computed their
    first torch.<op> (FIRST_CALL_SIZE float32 on the CPU, on
    FIRST_CALL_THREADS threads)
    more than FIRST_CALL_REL relative off numpy's float64 result. The
    processes fork from one interpreter that has imported torch and numpy
    and then, by `setup`, done nothing more ("none"), imported the port
    ("port"), or called torch.<setup> on 16 elements (one thread)."""
    if setup not in FIRST_CALL_SETUPS:
        raise ValueError(f"unknown setup {setup!r}; expected one of {FIRST_CALL_SETUPS}")
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_CALL_ZYGOTE, setup, str(runs), str(FIRST_CALL_SIZE),
         str(FIRST_CALL_THREADS), repr(FIRST_CALL_REL), json.dumps(ops)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"first calls after {setup!r} failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("probe_reproducible", description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="the screens' device (cuda or cpu)")
    p.add_argument("--runs", type=int, default=32,
                   help="fresh processes per condition (0: no screens)")
    p.add_argument("--conditions", default="default",
                   help=f"comma-separated, of {', '.join(CONDITIONS)}")
    p.add_argument("--dump", action="store_true", help="hash every stage's arrays")
    p.add_argument("--first_calls", type=int, default=0, metavar="N",
                   help="fresh processes per setup and function for the first-call check")
    p.add_argument("--zygote", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--model", help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.zygote:
        return zygote(args)
    import torch

    from ..device import resolve_device
    from .chip_ci import battery_model, write_battery_store

    device = resolve_device(args.device)
    conditions = args.conditions.split(",")
    summary: dict = {"device": str(device), "runs_per_condition": args.runs}
    if args.runs:
        with tempfile.TemporaryDirectory(prefix="probe_reproducible_") as tmp:
            tmp = Path(tmp)
            model = battery_model()
            model.save(str(tmp / "model.pm"))
            write_battery_store(tmp / "tiles", model, torch.device("cpu"))
            for condition in conditions:
                t0 = time.perf_counter()
                s = summarize(fork_screens(tmp / "model.pm", tmp / "tiles", tmp / condition,
                                           args.runs, str(device), condition, args.dump))
                s["seconds"] = time.perf_counter() - t0
                summary[condition] = s
                print(f"{condition}: {s['distinct_csvs']} distinct CSVs of {s['rows']} rows in "
                      f"{s['runs']} runs ({s['seconds']:.1f} s); differing runs: "
                      f"{s['differing_runs']}", flush=True)
    if args.first_calls:
        summary["first_calls"] = {}
        for setup in FIRST_CALL_SETUPS:
            t0 = time.perf_counter()
            bad = first_calls(setup, args.first_calls)
            summary["first_calls"][setup] = bad
            print(f"first calls after {setup!r}: off in {bad} of {args.first_calls} processes "
                  f"each ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
