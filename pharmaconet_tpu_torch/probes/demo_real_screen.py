"""A fragment-library SMILES file screened from text to scores through the
port's CLIs, with a kill and a resume, spot-checked against the exact host
matcher.

    python -m pharmaconet_tpu_torch.probes.demo_real_screen [--n 262144] \\
        [--work_dir DIR] [--report PATH] [--keep] [--device cuda]

1. `lib.smi` from `chem.fragments.enumerate_fragment_smiles(N, seed=11)`
   (N distinct molecules); the parse and the parse + perception timed on a
   sample in this process.
2. `python -m pharmaconet_tpu_torch.cli.prepack --smiles --embed_backend
   torch --device D` (--embed_backend numpy: on the host) in chunks of
   32,768 entries, chunk c0 with --seed 2025 + c0, so that entry i embeds
   with seed 2025 + i however the file is chunked; the parts merged into
   `lib.npz`.
3. `cli.prepack --library lib.npz --tiles_out tiles` (v3, leaves baked on
   --device).
4. `cli.screening --library_tiles`, killed on progress, resumed, and held
   byte for byte against an uninterrupted screen (`scale.kill_and_resume`).
5. --spot_checks sampled entries re-embedded by the same backend and
   device in one job, each
   with its own index seed (the embedder gives a molecule the same
   conformers in any chunk), and scored by `scoring.graph_match.GraphMatcher`, each
   within rtol 2e-5 / atol 1e-4 of its CSV score; the re-embedded
   pharmacophore node positions are compared with the packed library's.

Fails when a stage fails, fewer than 99.5% of the SMILES reach the CSV, or
a spot check misses.
"""

from __future__ import annotations

import json
import random
import sys
import time
from pathlib import Path

import numpy as np

from . import scale
from .scale import DemoError, log

SEED_BASE = 2025  # cli/prepack.py's --seed default
EMBED_CHUNK = 32_768  # SMILES per prepack --smiles process
SAMPLE = 16_384  # SMILES of the parse and perception timing


def build_parser():
    parser = scale.common_parser(__doc__.splitlines()[0], 262_144)
    parser.add_argument("--num_conformers", type=int, default=8)
    parser.add_argument("--embed_backend", default="torch", choices=("torch", "numpy"),
                        help="the prepack's and the spot checks' embedder: torch runs on "
                             "--device, numpy on the host")
    parser.add_argument("--batch_size", type=int, default=2048, help="ligands per stored batch")
    parser.add_argument("--kill_at", type=float, default=0.4,
                        help="share of the rows in <out>.partial at which phase A is killed")
    parser.add_argument("--spot_checks", type=int, default=256,
                        help="sampled entries held against the exact host matcher")
    return parser


def time_host_split(entries: list[tuple[str, str]], n: int) -> dict:
    """Parse and parse + perception, molecules/s on one core, on a sample
    of n entries spread over the library."""
    from ..chem.ligand_perception import get_pharmacophore_nodes
    from ..chem.smiles import parse_smiles

    sample = entries[:: max(1, len(entries) // n)][:n]
    t0 = time.perf_counter()
    for _, smi in sample:
        parse_smiles(smi).strip_hydrogens()
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, smi in sample:
        get_pharmacophore_nodes(parse_smiles(smi).strip_hydrogens())
    t_both = time.perf_counter() - t0
    return dict(n=len(sample), parse_per_s=len(sample) / t_parse,
                parse_and_perception_per_s=len(sample) / t_both)


def spot_check(model, entries: list[tuple[str, str]], indices: list[int], scores: dict,
               library: dict, num_conformers: int, device, backend: str = "torch") -> dict:
    """Entries `indices` re-embedded by `backend` (torch: on `device`), each with its own seed
    SEED_BASE + index (one embed job, as a prepack chunk runs; per-entry
    generators make a molecule's conformers the same in any chunk), and
    scored by GraphMatcher against their CSV scores. library: name -> the
    packed library's PackedLigand, whose node positions the re-embedded
    ones are compared with. An entry missing from the CSV was skipped by the
    prepack and is counted, not checked."""
    from ..scoring.batch_screen import PackedLigand
    from ..scoring.graph_match import GraphMatcher
    from ..scoring.parse_pool import _embed_chunk_job

    wanted = [i for i in indices if entries[i][0] in scores]
    jobs = [(*entries[i], SEED_BASE + i) for i in wanted]
    embedded = dict(_embed_chunk_job((jobs, num_conformers, backend, str(device))))
    checked, worst, worst_pos = 0, 0.0, 0.0
    misses: list[dict] = []
    for i in wanted:
        name = entries[i][0]
        if name not in embedded:
            misses.append(dict(name=name, reason="no conformers re-embedded"))
            continue
        expected = GraphMatcher(model, embedded[name]).run()
        pos = PackedLigand.from_ligand(embedded[name]).node_pos
        stored = library[name].node_pos
        pos_diff = (float(np.abs(pos - stored).max()) if pos.shape == stored.shape
                    else float("inf"))
        worst_pos = max(worst_pos, pos_diff)
        worst = max(worst, abs(scores[name] - expected))
        checked += 1
        if not scale.close(scores[name], expected):
            misses.append(dict(name=name, csv=scores[name], exact=expected,
                               node_pos_max_diff=pos_diff))
    return dict(sampled=len(indices), checked=checked, skipped=len(indices) - len(wanted),
                failed=len(misses), max_abs_diff=worst, node_pos_max_diff=worst_pos,
                misses=misses[:20])


def body(args, work: Path, report: dict) -> None:
    from ..chem.fragments import enumerate_fragment_smiles
    from ..device import resolve_device
    from ..scoring.library import load_library, save_library
    from ..synthetic import make_synthetic_model

    device = resolve_device(args.device)
    n = args.n
    report.update(distinct=n, num_conformers=args.num_conformers, batch_size=args.batch_size,
                  embed_backend=args.embed_backend,
                  library="chem/fragments.py enumerate_fragment_smiles, seed 11")
    model = make_synthetic_model(seed=3)
    model_path = work / "model.pm"
    model.save(str(model_path))

    t0 = time.perf_counter()
    entries = enumerate_fragment_smiles(n, seed=11)
    with open(work / "lib.smi", "w") as f:
        f.writelines(f"{smi} {name}\n" for name, smi in entries)
    report["gen_s"] = time.perf_counter() - t0
    report["host_split"] = time_host_split(entries, min(SAMPLE, n))
    log(f"library: {n} SMILES in {report['gen_s']:.1f} s; {report['host_split']}")

    parts, chunks = [], []
    t0 = time.perf_counter()
    for c0 in range(0, n, EMBED_CHUNK):
        smi_part, part = work / f"lib_{c0:07d}.smi", work / f"lib_{c0:07d}.npz"
        with open(smi_part, "w") as f:
            f.writelines(f"{smi} {name}\n" for name, smi in entries[c0:c0 + EMBED_CHUNK])
        stage = scale.run_stage(
            f"prepack --smiles chunk {c0}",
            scale.cli("prepack", "--smiles", smi_part, "-o", part, "--embed_backend",
                      args.embed_backend,
                      "--device", device, "--num_conformers", args.num_conformers,
                      "--seed", SEED_BASE + c0), work)
        chunks.append(scale.stage_record(stage))
        parts.append(part)
    if len(parts) == 1:
        parts[0].rename(work / "lib.npz")
    else:
        packed, names = [], []
        for part in parts:
            p, nm = load_library(part)
            packed += p
            names += nm
            part.unlink()
        save_library(work / "lib.npz", packed, names)
        del packed, names
    embed_s = time.perf_counter() - t0
    report["smiles_prepack"] = dict(seconds=embed_s, smiles_per_s=n / embed_s,
                                    chunk=EMBED_CHUNK, chunks=chunks)
    log(f"prepack --smiles: {embed_s:.1f} s ({n / embed_s:.1f} SMILES/s)")

    tiles = work / "tiles"
    stage = scale.run_stage(
        "prepack --tiles_out", scale.cli("prepack", "--library", work / "lib.npz", "-p",
                                         model_path, "--tiles_out", tiles, "--batch_size",
                                         args.batch_size, "--device", device), work)
    store_bytes = scale.dir_bytes(tiles)
    meta = json.loads((tiles / "meta.json").read_text())
    n_rows = meta["n_ligands"]
    report["tiles_prepack"] = dict(
        scale.stage_record(stage), ligands_per_s=n_rows / stage["seconds"],
        store_bytes=store_bytes, bytes_per_ligand=store_bytes / n_rows, store_meta=meta)
    log(f"prepack --tiles_out: {stage['seconds']:.1f} s, {store_bytes / 1e9:.3f} GB")
    if n_rows < 0.995 * n:
        raise DemoError(f"too many skipped molecules: {n_rows} of {n} packed")

    out_csv = work / "scores.csv"
    screen = scale.kill_and_resume(
        "screen", lambda out: scale.cli("screening", "-p", model_path, "--library_tiles", tiles,
                                        "-o", out, "--device", device),
        out_csv, n_rows, args.kill_at, work)
    report["screen"] = screen
    report["launches"] = scale.screen_launches(screen)
    report["sustained_ligands_per_s"] = screen["uninterrupted"]["ligands_per_s"]
    report["peak_rss_gib"] = screen["peak_rss_gib"]
    report["skipped_molecules"] = n - n_rows

    scores = scale.read_scores(out_csv)
    packed, names = load_library(work / "lib.npz")
    library = dict(zip(names, packed))
    indices = sorted(random.Random(0).sample(range(n), min(args.spot_checks, n)))
    t0 = time.perf_counter()
    check = spot_check(model, entries, indices, scores, library, args.num_conformers, device,
                       args.embed_backend)
    check["seconds"] = time.perf_counter() - t0
    report["spot_check"] = check
    log(f"spot checks against GraphMatcher: {check['checked']} checked, {check['failed']} "
        f"failed, largest difference {check['max_abs_diff']:.3g}, node positions "
        f"{check['node_pos_max_diff']:.3g} from the packed library")
    if check["failed"] or check["checked"] + check["skipped"] != check["sampled"]:
        raise DemoError(f"spot checks missed: {check}")


def main(argv: list[str] | None = None) -> int:
    return scale.run_demo("demo_real_screen", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
