"""Multi-process ligand parsing and SMILES embedding (host input pipeline).

Scoring runs on the device, so the pool covers PARSING + perception (and
the numpy embedder) only — the host processes feed the device instead of
competing with it. Workers run in a spawn context and import only the
chemistry stack, so they never touch the CUDA runtime; the torch embedder
runs in the calling process alone.
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


def _embed_chunk_job(job):
    """Parse + batch-embed one chunk of (name, smiles, seed) entries on
    the job's backend and device.

    Batching molecules through embed_conformers_many amortizes the MDS /
    refinement over one bucketed array program instead of per-molecule
    numpy dispatches; per-molecule rng streams keep the result for each
    molecule independent of the chunking."""
    entries, num_conformers, backend, device = job
    from pharmaconet_tpu_torch.chem.embed import embed_conformers_many
    from pharmaconet_tpu_torch.chem.smiles import parse_smiles
    from pharmaconet_tpu_torch.scoring.ligand import Ligand

    parsed = []
    for name, smi, seed in entries:
        try:
            mol = parse_smiles(smi)
            if any(a.atomic_num == 1 for a in mol.atoms):
                mol = mol.strip_hydrogens()
            parsed.append((name, smi, seed, mol))
        except Exception as e:  # noqa: BLE001 - tolerant library iteration
            print(f"skip {name} ({smi}): {e}", file=sys.stderr)
    confs = embed_conformers_many(
        [m for *_x, m in parsed],
        num_conformers,
        seeds=[s for _n, _s2, s, _m in parsed],
        backend=backend,
        device=device,
    )
    results = []
    for (name, smi, seed, mol), c in zip(parsed, confs):
        if isinstance(c, Exception):
            print(f"skip {name} ({smi}): {c}", file=sys.stderr)
            continue
        mol.coords = c[0]
        results.append((name, Ligand(mol, c, conformer_axis=0)))
    return results


def iter_embedded(
    entries: list[tuple[str, str]],
    cpus: int = 1,
    num_conformers: int = 8,
    seed: int = 2025,
    chunksize: int = 64,
    backend: str = "auto",
    device: str = "cuda",
) -> Iterator[tuple[str, object]]:
    """Yield (name, Ligand) for (name, smiles) entries via the in-house
    distance-geometry embedder (chem/embed.py), skipping failures.

    Each entry embeds with seed + its index from its own rng stream, so
    results are deterministic and independent of cpus/chunksize. backend
    "torch" runs each embed chunk as one program on `device` (the card's
    prepack path): it forces cpus=1, so no worker touches the device,
    and hands the embedder jobs of at least 4096 entries. "auto" is
    resolved here (PMNET_EMBED_BACKEND, else numpy), before any worker
    starts."""
    from pharmaconet_tpu_torch.chem.embed import _resolve_backend

    backend = _resolve_backend(backend)
    device = str(device)
    if backend == "torch":
        # the device path fills embed._CHUNK_ROWS-row dispatch buckets
        # (256 molecules at 8 conformers); small jobs would split them
        # further per atom-count bucket into short, launch-bound
        # dispatches. Per-entry seeds make job size result-invariant, so
        # hand the device big jobs.
        chunksize = max(chunksize, 4096)
        cpus = 1
    jobs = [
        (
            [
                (name, smi, seed + i + c0)
                for i, (name, smi) in enumerate(entries[c0 : c0 + chunksize])
            ],
            num_conformers,
            backend,
            device,
        )
        for c0 in range(0, len(entries), chunksize)
    ]
    for chunk_results in _run_jobs(_embed_chunk_job, jobs, cpus, 1):
        yield from chunk_results


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
