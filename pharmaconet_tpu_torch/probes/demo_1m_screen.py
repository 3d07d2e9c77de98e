"""Sustained screening of a large synthetic library through the stored
route, with a kill and a resume.

    python -m pharmaconet_tpu_torch.probes.demo_1m_screen [--n 1000000] \\
        [--work_dir DIR] [--report PATH] [--keep] [--device cuda] [--store 3]

1. Library: `synthetic.make_synthetic_model(seed=3)` and min(N, --distinct)
   distinct ligands from `make_synthetic_ligands(seed=7)`, replicated to N
   under their own names `l{i:07d}` (ligand i is distinct ligand
   i % distinct; the report declares it).
2. Store: `scoring.tiled_store.write_v3_store` in this process, its leaves
   baked on --device by the plain reference engine (--store 2:
   `write_tiled_store`, the v2 layout that K3 screens).
3. Screen: `python -m pharmaconet_tpu_torch.cli.screening --library_tiles`
   in a subprocess, sent SIGKILL once <out>.partial holds --kill_at of the
   rows; the same command again, which resumes; then an uninterrupted
   screen into another CSV (`scale.kill_and_resume`).

Checks: the kill landed mid-run; the resumed CSV is byte-equal to the
uninterrupted one and has N rows; 2,000 sampled ligands score
within rtol 2e-5 / atol 1e-4 of their distinct original. Records the
generation and prepack seconds and rates, the store's bytes (per ligand)
and meta, the rows at the kill, each screen's seconds, ligands/s and peak
RSS (the screening process's own), and its kernel launches.
"""

from __future__ import annotations

import random
import sys
import time
from pathlib import Path

from . import scale
from .scale import DemoError, log

REPLICA_CHECKS = 2000  # sampled ligands held against their distinct original
# the screening CLI's default weights (cli/screening.py), baked into the store
WEIGHTS = dict(Cation=8.0, Anion=8.0, Aromatic=4.0, HBond_donor=4.0, HBond_acceptor=4.0,
               Halogen=4.0, Hydrophobic=1.0)


def build_parser():
    parser = scale.common_parser(__doc__.splitlines()[0], 1_000_000)
    parser.add_argument("--distinct", type=int, default=65_536,
                        help="distinct ligands, replicated to --n")
    parser.add_argument("--batch_size", type=int, default=2048, help="ligands per stored batch")
    parser.add_argument("--store", type=int, default=3, choices=(2, 3), help="store layout")
    parser.add_argument("--kill_at", type=float, default=0.4,
                        help="share of the rows in <out>.partial at which phase A is killed")
    return parser


def body(args, work: Path, report: dict) -> None:
    from ..device import resolve_device
    from ..scoring.batch_screen import PackedModel
    from ..scoring.tiled_store import write_tiled_store, write_v3_store
    from ..synthetic import make_synthetic_ligands, make_synthetic_model

    device = resolve_device(args.device)
    n, n_distinct = args.n, min(args.n, args.distinct)
    report.update(distinct=n_distinct, batch_size=args.batch_size, store_version=args.store,
                  replication=f"ligand i is distinct ligand i % {n_distinct}, named l{{i:07d}}")
    model = make_synthetic_model(seed=3)
    model_path = work / "model.pm"
    model.save(str(model_path))

    t0 = time.perf_counter()
    distinct = make_synthetic_ligands(n_distinct, seed=7)
    packed = [distinct[i % n_distinct] for i in range(n)]
    names = [f"l{i:07d}" for i in range(n)]
    report["gen_s"] = time.perf_counter() - t0
    log(f"library: {n} ligands ({n_distinct} distinct) in {report['gen_s']:.1f} s")

    tiles = work / "tiles"
    pm = PackedModel.from_model(model, WEIGHTS)
    t0 = time.perf_counter()
    if args.store == 3:
        meta = write_v3_store(tiles, pm, packed, names, batch_size=args.batch_size,
                              device=str(device), verbose=False)
    else:
        meta = write_tiled_store(tiles, pm, packed, names, batch_size=args.batch_size,
                                 verbose=False)
    prepack_s = time.perf_counter() - t0
    del packed, distinct, names
    store_bytes = scale.dir_bytes(tiles)
    report["prepack"] = dict(seconds=prepack_s, ligands_per_s=n / prepack_s,
                             store_bytes=store_bytes, bytes_per_ligand=store_bytes / n,
                             store_meta=meta)
    log(f"prepack: {prepack_s:.1f} s ({n / prepack_s:.1f} ligands/s), "
        f"{store_bytes / 1e9:.3f} GB")

    out_csv = work / "scores.csv"
    screen = scale.kill_and_resume(
        "screen", lambda out: scale.cli("screening", "-p", model_path, "--library_tiles", tiles,
                                        "-o", out, "--device", device),
        out_csv, n, args.kill_at, work)
    report["screen"] = screen
    report["launches"] = scale.screen_launches(screen)
    report["sustained_ligands_per_s"] = screen["uninterrupted"]["ligands_per_s"]
    report["peak_rss_gib"] = screen["peak_rss_gib"]

    scores = scale.read_scores(out_csv)
    rng = random.Random(0)
    checked, worst = 0, 0.0
    for _ in range(REPLICA_CHECKS):
        i = rng.randrange(n)
        j = i % n_distinct
        if i == j:
            continue
        a, b = scores[f"l{i:07d}"], scores[f"l{j:07d}"]
        worst = max(worst, abs(a - b))
        if not scale.close(a, b):
            raise DemoError(f"replica l{i:07d} scores {a}, its original l{j:07d} {b}")
        checked += 1
    report["replica_check"] = dict(checked=checked, max_abs_diff=worst)
    log(f"screen: {screen['uninterrupted']['ligands_per_s']:.1f} ligands/s sustained, "
        f"kill at {screen['phase_a']['rows_in_partial']} rows, resumed CSV byte-equal; "
        f"{checked} replica pairs within tolerance")


def main(argv: list[str] | None = None) -> int:
    return scale.run_demo("demo_1m_screen", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
