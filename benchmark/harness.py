"""The benchmark's driver: one cell of BENCHMARK.json, one run.

Everything a cell needs is found by name. A cell (`workloads` entry) names
a configuration, whose file `BENCHMARK.json` gives, and a traffic mix,
`traffic/<name>.json`; the mix names its route, `routes/<route>.py`, the
code that sets the system up and runs one pass of it; each metric is a
reader, `metrics/<name>.py`, with `read(records)` returning its value or
None where the run has nothing for it to read; a metric `<base>.<part>`
without a file of its own is `<base>`'s quantity, split by the end-to-end
metric it moves, and reads with `metrics/<base>.py`. A later cell, mix,
route or metric is a new file and a new entry: nothing here names one.

A run: set-up (imports, inputs from the seed, the route's set-up and one
warm pass) is `setup_s`; then passes run back to back until `--seconds`
have gone by, the last one to its end. With `--trace 1` the window runs
under `torch.profiler` with spans around the program's calls, and the
per-layer metrics are read from it. Without a trace the window runs under
the profiler, with no spans, only where one of the cell's end-to-end
metrics comes from the device trace. After the window the program's state
is freed and the route's check compares what the passes produced with the
plain reference.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import device_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pharmaconet_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]  # where the program under test lives


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench_dir: Path, workload: str) -> SimpleNamespace:
    """The cell's entries and files, found by name."""
    root = bench_dir.parent
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return SimpleNamespace(
        spec=spec, cell=cell, config=load_json(root / config_entry["file"]),
        traffic=traffic, route=bench_dir / "routes" / f"{traffic['route']}.py",
    )


def cell_metrics(spec: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with a trace its per-layer ones (those that list the cell, or that
    list no cells and move one of the cell's end-to-end metrics)."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def metric_path(bench_dir: Path, name: str) -> Path:
    """The reader of metric `name`: `metrics/<name>.py`, or for a split
    metric `<base>.<part>` without a file of its own, `metrics/<base>.py`."""
    own = bench_dir / "metrics" / f"{name}.py"
    return own if own.is_file() else bench_dir / "metrics" / f"{name.split('.')[0]}.py"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


@contextlib.contextmanager
def _profiled(on: bool, device: str):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def run_cell(bench_dir: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> tuple[dict, list[str]]:
    """One run of a cell on `device`: the result line's object and the
    lines that name each number compared beside its limit."""
    import torch

    found = find_cell(bench_dir, workload)
    route_module = load_module(found.route, f"route_{found.traffic['route']}")
    work_dir = tempfile.mkdtemp(prefix="bench-")  # under the run's TMPDIR
    try:
        ctx = SimpleNamespace(config=found.config, traffic=found.traffic, seed=seed,
                              device=device, work_dir=work_dir, root=CHECKOUT)
        route = route_module.Route(ctx)
        route.setup()
        cuda = device.startswith("cuda")
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        store_bytes = route.store_bytes()

        reported = cell_metrics(found.spec, workload, trace)
        profiled = trace or any(m["source"] == "device_trace" for m in reported)
        rec = device_trace.Recorder() if profiled else None
        passes, ends = [], []
        with _profiled(profiled, device) as prof:
            with route.instrument(rec) if trace else contextlib.nullcontext():
                with rec.span("bench.window") if profiled else contextlib.nullcontext():
                    w0 = time.perf_counter()
                    while True:
                        passes.append(route.run_pass())
                        ends.append(time.perf_counter() - w0)
                        if ends[-1] >= seconds:
                            break
        elapsed = ends[-1]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        timeline = device_trace.timeline(prof) if profiled else None
        del prof
        route.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        checks, attempted, failed = route.check(passes)
        records = dict(setup_s=setup_s, window_s=elapsed, passes=len(passes),
                       items=len(passes) * route.items_per_pass, timeline=timeline)
        if trace:
            ops, nbytes = route.work()
            records.update(spans=dict(rec.durations), counts=dict(rec.counts),
                           work=dict(ops=ops * len(passes), bytes=nbytes * len(passes)))
        metrics = {}
        for m in reported:
            path = metric_path(bench_dir, m["name"])
            value = load_module(path, f"metric_{path.stem}").read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = dict(
            platform="gpu" if cuda else "cpu",
            kind=torch.cuda.get_device_name(device) if cuda else "cpu",
            count=int(found.cell["chips"]) if cuda else 1,
            memory_peak_bytes=int(peak),
        )
        result = dict(correct=all(v <= lim for _, v, lim in checks),
                      attempted=attempted, failed=failed, metrics=metrics, device=dev)
        if trace:
            busy = device_trace.busy_ns(timeline)
            dev.update(busy_s=busy / 1e9 if busy is not None else 0.0, window_s=elapsed)
            result["breakdown"] = dict(
                device_ops=[[n[:160], s] for n, s in device_trace.top_ops(timeline)],
                idle_gaps=[[n, s] for n, s in device_trace.idle_gaps(timeline)[:10]])
        result["info"] = dict(
            passes=len(passes), window_s=elapsed, store_bytes=store_bytes,
            pass_s=[b - a for a, b in zip([0.0] + ends, ends)],
            setup_split=getattr(route, "setup_split", {}),
            card=nvidia_smi() if cuda else None)
        result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
        lines = [f"check {n} {v} limit {lim}" for n, v, lim in checks]
        return result, lines
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser("benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench_dir = Path(__file__).resolve().parent
    chips = int(find_cell(bench_dir, args.workload).cell["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    result, lines = run_cell(bench_dir, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
