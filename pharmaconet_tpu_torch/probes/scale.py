"""Shared parts of the scale demos (`demo_1m_screen`, `demo_real_screen`,
`demo_train_scale`): their common arguments, the report, stages run once in
subprocesses with their wall time, peak RSS and kernel launches, and the
screen that is killed on progress and then resumed.

Each demo runs as `python -m pharmaconet_tpu_torch.probes.<demo>` with
--n, --work_dir (a fresh temporary directory by default), --report
(default <work_dir>/report.json), --keep and --device (default cuda). It
drives the port's CLIs in subprocesses, writes only under its work
directory and to its report, prints the report as its last line, and
exits 1 on any missed check. Every stage runs once: a stage that fails or
outlives STAGE_TIMEOUT_S fails the demo, and nothing moves to the CPU on
its own.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

from ..ops import launch_log

RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance
PACKAGE_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package
STAGE_TIMEOUT_S = 3600.0  # a stage still running after this counts as hung


class DemoError(AssertionError):
    """A demo's stage failed or one of its checks missed."""


def log(msg: str) -> None:
    print(f"[demo] {msg}", flush=True)


def common_parser(description: str, n: int, n_help: str = "library size"
                  ) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--n", type=int, default=n, help=n_help)
    parser.add_argument("--work_dir", type=str, default=None,
                        help="where the demo writes (default: a fresh temporary directory)")
    parser.add_argument("--report", type=str, default=None,
                        help="report JSON path (default <work_dir>/report.json)")
    parser.add_argument("--keep", action="store_true",
                        help="keep the work directory's stores and files")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def close(got: float, want: float) -> bool:
    return abs(got - want) <= ATOL + RTOL * abs(want)


def run_demo(name: str, args, body, kind: str = "demo") -> int:
    """Run `body(args, work, report)` in an empty work directory; write and
    print the report (`{kind: name, ...}`); return 0, or 1 (the traceback on
    stderr, `ok` false and `error` set in the report) when body raised. The
    work directory's files go unless --keep, or unless it was given and the
    demo failed."""
    from ..device import resolve_device

    resolve_device(args.device)  # cuda without a card raises before any work
    fresh = args.work_dir is None
    work = Path(tempfile.mkdtemp(prefix=f"{name}_")) if fresh else Path(args.work_dir)
    if not fresh and work.exists() and any(work.iterdir()):
        raise DemoError(f"--work_dir {work} is not empty")
    work.mkdir(parents=True, exist_ok=True)
    report_path = Path(args.report) if args.report else work / "report.json"
    report: dict = {kind: name, "ok": False, "n": args.n, "device": str(args.device)}
    t0 = time.perf_counter()
    try:
        if str(args.device).startswith("cuda"):
            import torch

            report["card"] = torch.cuda.get_device_name(0)
            report["build_s"] = build()
        body(args, work, report)
        report["ok"] = True
    except Exception as e:  # noqa: BLE001 - a failed demo reports, then exits 1
        report["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    finally:
        report["wall_s"] = time.perf_counter() - t0
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(report, indent=1))
        if not args.keep and (fresh or report["ok"]):
            for child in work.iterdir():
                if child != report_path:
                    shutil.rmtree(child) if child.is_dir() else child.unlink()
            if fresh and report_path.parent != work:
                work.rmdir()
        print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


def build() -> float:
    """Build (or load from the package's build cache) the CUDA kernels and
    the native host libraries before any stage runs, so that no stage's
    time holds a compiler run; returns the seconds."""
    from .. import native
    from ..ops import screen_cuda, voxelize_cuda

    t0 = time.perf_counter()
    for load in (screen_cuda.load_library, voxelize_cuda.load_library, native.get_pack_tiled,
                 native.get_block_packer, native.get_prep_args, native.get_match_dfs,
                 native.get_tile_dt):
        load()
    return time.perf_counter() - t0


def cli(module: str, *args) -> list[str]:
    """The command line of one of the port's CLIs."""
    return [sys.executable, "-m", f"pharmaconet_tpu_torch.cli.{module}", *map(str, args)]


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


class RowCounter:
    """Complete lines of a file that another process appends to, read
    incrementally."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.offset = 0
        self.rows = 0

    def poll(self) -> int:
        if self.path.exists():
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
            self.offset += len(chunk)
            self.rows += chunk.count(b"\n")
        return self.rows


def count_rows(path: Path) -> int:
    with open(path, "rb") as f:
        return f.read().count(b"\n")


def run_stage(label: str, cmd: list[str], work: Path, watch=None, poll_s: float = 0.002,
              expect_rc: int = 0, timeout: float = STAGE_TIMEOUT_S) -> dict:
    """Run cmd once, its output read line by line and timed. watch, if
    given, is polled while it runs; when it returns True the process is
    sent SIGKILL. Returns the exit code, whether it was killed, its wall
    seconds, peak RSS (GiB, the process's own, from wait4), its kernel
    launches (ops/launch_log.py; None when it wrote none, as a killed
    process does) and its output lines with their arrival seconds. A
    process that outlives `timeout` is killed and fails the demo, as does
    one that exits with another code than `expect_rc`."""
    log_path = work / "launches.jsonl"
    # this package first on the child's path; its output unbuffered, so
    # that each line arrives (and is timed) when it is printed
    path = os.pathsep.join(p for p in (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH")) if p)
    env = {**os.environ, launch_log.ENV: str(log_path), "PYTHONPATH": path,
           "PYTHONUNBUFFERED": "1"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, bufsize=1)
    lines: list[tuple[float, str]] = []

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    killed = hung = False
    while True:
        pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
        if pid:
            break
        if time.perf_counter() - t0 > timeout:
            hung = True
        elif watch is None or not watch():
            time.sleep(poll_s)
            continue
        killed = True
        os.kill(proc.pid, signal.SIGKILL)
        pid, status, usage = os.wait4(proc.pid, 0)
        break
    wall = time.perf_counter() - t0
    proc.returncode = os.waitstatus_to_exitcode(status)
    reader.join()
    proc.stdout.close()
    out = dict(rc=proc.returncode, killed=killed, seconds=wall,
               peak_rss_gib=usage.ru_maxrss * 1024 / 2**30,
               launches=launch_log.read(log_path, proc.pid), lines=lines)
    log(f"{label}: rc {proc.returncode}{' (killed)' if killed else ''} in {wall:.2f} s, "
        f"peak RSS {out['peak_rss_gib']:.3f} GiB")
    if hung:
        raise DemoError(f"{label}: no end after {timeout:.0f} s: " + tail(lines))
    if not killed and proc.returncode != expect_rc:
        raise DemoError(f"{label} exited {proc.returncode}: " + tail(lines))
    return out


def tail(lines: list[tuple[float, str]], n: int = 30) -> str:
    return "\n".join(line for _, line in lines[-n:])


def stage_record(stage: dict, rows: int | None = None, ready: str | None = None) -> dict:
    """A stage's numbers for the report (its output left out). rows: the
    rows it scored, for its rates; ready: the output line that marks the
    end of its start-up, for the rate after it."""
    rec = {k: v for k, v in stage.items() if k != "lines"}
    if rows is not None:
        rec["rows"] = rows
        rec["ligands_per_s"] = rows / stage["seconds"]
        start = next((t for t, line in stage["lines"] if ready and line.startswith(ready)), None)
        if start is not None:
            rec["startup_s"] = start
            rec["ligands_per_s_after_startup"] = rows / (stage["seconds"] - start)
    return rec


def kill_and_resume(label: str, cmd_for, out_csv: Path, n_rows: int, kill_at: float,
                    work: Path) -> dict:
    """The screen `cmd_for(out_csv)` three times: phase A, sent SIGKILL once
    <out>.partial holds kill_at of the n_rows rows; phase B, the same
    command, which resumes from <out>.partial; then an uninterrupted screen
    into another CSV. Fails unless the kill landed mid-run (0 < rows in
    .partial < n_rows, no CSV written), phase B resumed those rows, and the
    resumed CSV is byte-equal to the uninterrupted one with n_rows rows."""
    if not 0.0 < kill_at:
        raise ValueError(f"kill_at {kill_at} must be above 0")
    partial = Path(f"{out_csv}.partial")
    full_csv = out_csv.with_name(f"{out_csv.stem}_uninterrupted{out_csv.suffix}")
    for path in (out_csv, partial, full_csv, Path(f"{full_csv}.partial")):
        path.unlink(missing_ok=True)
    threshold = max(1, math.ceil(kill_at * n_rows))
    counter = RowCounter(partial)
    a = run_stage(f"{label} phase A", cmd_for(out_csv), work,
                  watch=lambda: counter.poll() >= threshold)
    if not a["killed"]:
        raise DemoError(f"{label} phase A ended (rc {a['rc']}) before {partial.name} held "
                        f"{threshold} of {n_rows} rows: nothing was killed")
    rows_a = count_rows(partial) if partial.exists() else 0
    if not 0 < rows_a < n_rows or out_csv.exists():
        raise DemoError(f"{label}: the kill did not land mid-run: {rows_a} of {n_rows} rows in "
                        f"{partial.name}, CSV written: {out_csv.exists()}")
    b = run_stage(f"{label} phase B (resume)", cmd_for(out_csv), work)
    resumed = [line for _, line in b["lines"] if line.startswith("resuming:")]
    if resumed != [f"resuming: {rows_a} ligands already scored in {partial}"]:
        raise DemoError(f"{label} phase B did not resume {rows_a} rows: {resumed}")
    if partial.exists():
        raise DemoError(f"{label} phase B left {partial.name} behind")
    c = run_stage(f"{label} uninterrupted", cmd_for(full_csv), work)
    resumed_bytes, full_bytes = out_csv.read_bytes(), full_csv.read_bytes()
    rows = full_bytes.count(b"\n") - 1
    if resumed_bytes != full_bytes:
        raise DemoError(f"{label}: the resumed CSV differs from the uninterrupted one")
    if rows != n_rows:
        raise DemoError(f"{label}: {rows} rows in the CSV, not {n_rows}")
    ready = "tile store:"
    return dict(
        kill_at=kill_at,
        phase_a=dict(stage_record(a), rows_in_partial=rows_a),
        phase_b=stage_record(b, n_rows - rows_a, ready),
        uninterrupted=stage_record(c, n_rows, ready),
        resumed_csv_byte_equal=True, rows=rows,
        peak_rss_gib=max(s["peak_rss_gib"] for s in (a, b, c)),
        resume_cost_s=a["seconds"] + b["seconds"] - c["seconds"])


def read_scores(path: Path) -> dict[str, float]:
    scores: dict[str, float] = {}
    with open(path) as f:
        next(f)
        for line in f:
            name, s = line.rstrip("\n").rsplit(",", 1)
            scores[name] = float(s)
    return scores


def screen_launches(record: dict) -> dict[str, int]:
    """Launches of the screens that exited normally (phase B and the
    uninterrupted screen: a killed process logs none), by kernel."""
    out: dict[str, int] = {}
    for part in ("phase_b", "uninterrupted"):
        for k, v in (record[part]["launches"] or {}).items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}
