"""Kernel launch counts that outlive their process.

With PMNET_TORCH_LAUNCH_LOG naming a file, a process that imports the
package appends one JSON line to that file when it exits normally: its
pid, its argv and the launch counts (`LAUNCHES`) of each kernel wrapper
module it loaded (ops/screen_cuda.py, ops/voxelize_cuda.py). A program that
runs the CLIs in subprocesses reads their counts there (probes/scale.py).
A process killed by a signal, or left through os._exit, writes nothing
unless it calls `append` first.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from pathlib import Path

ENV = "PMNET_TORCH_LAUNCH_LOG"
WRAPPERS = ("pharmaconet_tpu_torch.ops.screen_cuda", "pharmaconet_tpu_torch.ops.voxelize_cuda")


def counts() -> dict[str, int]:
    """This process's launch counts of every loaded kernel wrapper."""
    out: dict[str, int] = {}
    for name in WRAPPERS:
        module = sys.modules.get(name)
        if module is not None:
            out.update(module.LAUNCHES)
    return out


def append() -> None:
    """Append this process's line to the log the environment names."""
    path = os.environ.get(ENV)
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv,
                                "launches": counts()}) + "\n")


def install_from_env() -> None:
    if os.environ.get(ENV):
        atexit.register(append)


def read(path: str | Path, pid: int) -> dict[str, int] | None:
    """The launch counts process `pid` appended to `path`, or None."""
    path = Path(path)
    if not path.exists():
        return None
    found = None
    for line in path.read_text().splitlines():
        record = json.loads(line)
        if record["pid"] == pid:
            found = record["launches"]
    return found
