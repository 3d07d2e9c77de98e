"""Machine code of two builds of the screening kernels, kernel by kernel.

    python -m pharmaconet_tpu_torch.probes.sass_compare OLD.cu [NEW.cu]

Compiles each source to a cubin with the port's nvcc flags for sm_90a
(`-Xptxas -v`), disassembles both with `cuobjdump -sass` and holds every
kernel of OLD against the same kernel of NEW: its instructions (addresses
and encodings dropped), registers and spill bytes. A kernel is keyed by
its name and template arguments; a `screen_tile_kernel<C, MODE>` of a
build without the FLAGS parameter is the `<C, MODE, 0>` instance. NEW
defaults to the checkout's csrc/screen_fused.cu. Prints a line per kernel
of OLD and one JSON summary last; exits 1 when a kernel of OLD compiles to
other code in NEW or is missing there. Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

from ..ops.screen_cuda import NVCC_FLAGS, SOURCE, nvcc_path

CUBIN_FLAGS = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
TEMPLATE_ARGS = re.compile(r"I((?:Li-?\d+E)+)E")


def kernel_key(mangled: str) -> str | None:
    """`name<args>` of a mangled kernel name: the first length-prefixed
    identifier ending in `_kernel`, with its integer template arguments."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end() : m.end() + int(m.group())]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            targs = TEMPLATE_ARGS.match(mangled, m.end() + len(name))
            args = [int(a) for a in re.findall(r"Li(-?\d+)E", targs.group(1))] if targs else []
            if name == "screen_tile_kernel" and len(args) == 2:
                args.append(0)  # a build before the FLAGS parameter
            return f"{name}<{', '.join(map(str, args))}>" if args else name
    return None


@dataclass
class Kernel:
    instructions: list[str] = field(default_factory=list)
    registers: int | None = None
    spill_stores: int | None = None
    spill_loads: int | None = None


def parse_sass(text: str, kernels: dict[str, Kernel]) -> None:
    """Adds each function of `cuobjdump -sass` output to `kernels`."""
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            key = kernel_key(m.group(1))
            current = kernels.setdefault(key, Kernel()) if key else None
            continue
        m = INSTRUCTION.search(line)
        if m and current is not None:
            current.instructions.append(" ".join(m.group(1).split()))


def parse_ptxas(text: str, kernels: dict[str, Kernel]) -> None:
    """Adds the registers and spill bytes of `ptxas -v` output."""
    current = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            key = kernel_key(m.group(1))
            current = kernels.setdefault(key, Kernel()) if key else None
        elif current is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                current.spill_stores, current.spill_loads = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current.registers = int(m.group(1))


def build(sources: list[Path], out_dir: Path) -> list[dict[str, Kernel]]:
    """Compiles the sources in parallel; their kernels."""
    nvcc = nvcc_path()
    cubins = [out_dir / f"{i}.cubin" for i in range(len(sources))]
    procs = [subprocess.Popen([nvcc, "-cubin", *CUBIN_FLAGS, "-Xptxas", "-v", "-o", str(c),
                               str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, c in zip(sources, cubins)]
    results = []
    for src, cubin, proc in zip(sources, cubins, procs):
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log[-4000:]}")
        kernels: dict[str, Kernel] = {}
        parse_ptxas(log, kernels)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True, timeout=600)
        parse_sass(sass.stdout, kernels)
        results.append(kernels)
    return results


def compare(old: dict[str, Kernel], new: dict[str, Kernel]) -> dict:
    rows, differ, missing = [], [], []
    for key in sorted(old):
        a, b = old[key], new.get(key)
        if b is None:
            missing.append(key)
            rows.append(f"{key}: missing from the new build")
            continue
        same = a.instructions == b.instructions
        if not same:
            differ.append(key)
        rows.append(f"{key}: {'same code' if same else 'OTHER CODE'} "
                    f"({len(a.instructions)} -> {len(b.instructions)} instructions), registers "
                    f"{a.registers} -> {b.registers}, spill stores/loads "
                    f"{a.spill_stores}/{a.spill_loads} -> {b.spill_stores}/{b.spill_loads} B")
    return dict(rows=rows, kernels=len(old), same=len(old) - len(differ) - len(missing),
                differ=differ, missing=missing, new_only=len(set(new) - set(old)))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old", type=Path)
    parser.add_argument("new", type=Path, nargs="?", default=SOURCE)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        old, new = build([args.old, args.new], Path(tmp))
    result = compare(old, new)
    for row in result.pop("rows"):
        print(row, flush=True)
    print(json.dumps({"old": str(args.old), "new": str(args.new), **result}), flush=True)
    return 1 if result["differ"] or result["missing"] else 0


if __name__ == "__main__":
    sys.exit(main())
