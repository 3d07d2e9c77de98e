"""Multi-process ligand file parsing (host input pipeline).

Scoring runs on the device, so the pool covers PARSING + perception only —
the host processes feed the device instead of competing with it. Workers
run in a spawn context and import only the chemistry stack, so they never
touch the CUDA runtime. (Embedding SMILES waits for the port of
chem/embed.py.)
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Iterator


def _parse_one(job: tuple[str, int | None]):
    path_str, num_conformers = job
    from pharmaconet_tpu_torch.scoring.ligand import Ligand

    try:
        return path_str, Ligand.load_from_file(path_str, num_conformers)
    except Exception as e:  # noqa: BLE001 - tolerant library iteration
        print(f"skip {path_str}: {e}", file=sys.stderr)
        return None


def iter_parsed(
    paths: list[str | Path],
    cpus: int = 1,
    num_conformers: int | None = None,
    chunksize: int = 16,
) -> Iterator[tuple[str, object]]:
    """Yield (path, Ligand) in input order, skipping unparseable files."""
    jobs = [(str(p), num_conformers) for p in paths]
    yield from _run_jobs(_parse_one, jobs, cpus, chunksize)


def _run_jobs(fn, jobs, cpus: int, chunksize: int) -> Iterator:
    if cpus <= 1:
        for job in jobs:
            r = fn(job)
            if r is not None:
                yield r
        return
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Pool(processes=cpus) as pool:
        for r in pool.imap(fn, jobs, chunksize=chunksize):
            if r is not None:
                yield r
