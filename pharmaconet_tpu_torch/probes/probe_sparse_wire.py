"""The leaf wire, sparse against dense, end to end on fragment SMILES:
one library baked into two v3 stores that differ only in the leaf wire,
each screened by the screening CLI on the device.

    python -m pharmaconet_tpu_torch.probes.probe_sparse_wire [--n 32768] \\
        [--num_conformers 8] [--batch_size 2048] [--spot_checks 64] \\
        [--embed_backend torch|numpy] [--device cuda]

1. `lib.smi` from `chem.fragments.enumerate_fragment_smiles(N, seed=11)`,
   embedded by `python -m pharmaconet_tpu_torch.cli.prepack --smiles
   --embed_backend B --device D --seed 2025` (entry i with seed 2025 + i)
   into `lib.npz`; `synthetic.make_synthetic_model(seed=3)` as `model.pm`.
2. `cli.prepack --library lib.npz --tiles_out tiles_<wire> --leaf_wire
   dense|sparse` (leaves baked on --device): the store bytes, split into
   the core and the leaf files (`leafb*`).
3. `cli.screening --library_tiles tiles_<wire>` on --device for each
   store: wall seconds and ligands/s of the process.

Gates (`csv_gate`, `spot_gate`): the sparse CSV names the same ligands as
the dense one and every score is within rtol 2e-5 / atol 1e-4 of it;
--spot_checks entries re-embedded with their own seeds and scored by
`GraphMatcher` agree with the sparse CSV (`demo_real_screen.spot_check`).
Each stage is one call of the CLI's `main` in this process, timed on the
host clock around it (the interpreter's start-up left out; the CLI's own,
its device set-up and the store's names, kept), with the kernel launches
it made. The counterpart of the JAX `probes/probe_sparse_wire.py`, which
wrote `SPARSE_WIRE.json` into the repo; this probe writes only its report.
"""

from __future__ import annotations

import json
import random
import sys
import time
from pathlib import Path

import torch

from . import demo_real_screen, scale
from . import stored_route as sr
from .stored_route import log

WIRES = ("dense", "sparse")


def store_parser(description: str, n: int):
    """The flags of build_stores (shared with probe_sparse_split)."""
    p = sr.parser(description, n, "fragment SMILES")
    p.add_argument("--num_conformers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=2048, help="ligands per stored batch")
    p.add_argument("--embed_backend", default="torch", choices=("torch", "numpy"))
    return p


def build_parser():
    p = store_parser(__doc__.splitlines()[0], 32_768)
    p.add_argument("--spot_checks", type=int, default=64,
                   help="entries held against the exact host matcher")
    return p


def stage(label: str, module, argv: list) -> dict:
    """One CLI `main` call in this process: its wall seconds (host clock,
    synchronised) and the kernel launches it made; raises unless it
    exits 0."""
    from ..ops import launch_log

    before = launch_log.counts()
    t0 = time.perf_counter()
    rc = module.main(module.build_parser().parse_args([str(a) for a in argv]))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise sr.ProbeError(f"{label} exited {rc}")
    launches = {k: v - before.get(k, 0) for k, v in launch_log.counts().items()
                if v > before.get(k, 0)}
    log(f"{label}: {seconds:.2f} s, launches {launches}")
    return dict(seconds=seconds, launches=launches)


def build_stores(args, work: Path, report: dict) -> dict:
    """Steps 1-2: the model, the SMILES library and one store per wire
    under `work`; returns {"model": path, "entries": [...], wire: dir}."""
    from ..chem.fragments import enumerate_fragment_smiles
    from ..cli import prepack
    from ..synthetic import make_synthetic_model

    dev = sr.device_of(args)
    model_path = work / "model.pm"
    make_synthetic_model(seed=3).save(str(model_path))
    entries = enumerate_fragment_smiles(args.n, seed=11)
    with open(work / "lib.smi", "w") as f:
        f.writelines(f"{smi} {name}\n" for name, smi in entries)
    rec = stage("prepack --smiles", prepack, [
        "--smiles", work / "lib.smi", "-o", work / "lib.npz", "--embed_backend",
        args.embed_backend, "--device", dev, "--num_conformers", args.num_conformers,
        "--seed", demo_real_screen.SEED_BASE])
    report["smiles_prepack"] = dict(rec, smiles_per_s=args.n / rec["seconds"])
    out = {"model": model_path, "entries": entries}
    for wire in WIRES:
        tiles = work / f"tiles_{wire}"
        rec = stage(f"prepack --tiles_out --leaf_wire {wire}", prepack, [
            "--library", work / "lib.npz", "-p", model_path, "--tiles_out", tiles,
            "--batch_size", args.batch_size, "--leaf_wire", wire, "--device", dev])
        total = scale.dir_bytes(tiles)
        leaf = sum(p.stat().st_size for p in tiles.rglob("leafb*") if p.is_file())
        n_ligands = json.loads((tiles / "meta.json").read_text())["n_ligands"]
        report[f"store_{wire}"] = dict(
            rec, total_bytes=total, leaf_bytes=leaf, core_bytes=total - leaf,
            n_ligands=n_ligands, leaf_bytes_per_ligand=leaf / max(n_ligands, 1))
        log(f"{wire} store: {total / 1e6:.1f} MB, leaf {leaf / 1e6:.1f} MB "
            f"({leaf / max(n_ligands, 1):.1f} B per ligand)")
        out[wire] = tiles
    return out


def csv_gate(dense: dict[str, float], sparse: dict[str, float]) -> dict:
    """The sparse CSV against the dense one: the same ligands, every score
    within the repo tolerance (raises ProbeError otherwise)."""
    if dense.keys() != sparse.keys():
        raise sr.ProbeError("the sparse and dense CSVs name different ligands")
    names = sorted(dense)
    return dict(rows=len(names), **sr.gate_scores(
        "sparse CSV against dense CSV", [sparse[k] for k in names], [dense[k] for k in names]))


def spot_gate(check: dict) -> None:
    """Every sampled entry checked (or skipped by the prepack) and none
    missed."""
    if (check["failed"] or check["checked"] == 0
            or check["checked"] + check["skipped"] != check["sampled"]):
        raise sr.ProbeError(f"spot checks missed: {check}")


def body(args, work: Path, report: dict) -> None:
    from ..cli import screening
    from ..pharmacophore.model import PharmacophoreModel
    from ..scoring.library import load_library

    dev = sr.device_of(args)
    built = build_stores(args, work, report)
    scores = {}
    for wire in WIRES:
        out_csv = work / f"scores_{wire}.csv"
        rec = stage(f"screening --library_tiles ({wire})", screening, [
            "-p", built["model"], "--library_tiles", built[wire], "-o", out_csv,
            "--device", dev])
        scores[wire] = scale.read_scores(out_csv)
        report[f"screen_{wire}"] = dict(rec, rows=len(scores[wire]),
                                        ligands_per_s=len(scores[wire]) / rec["seconds"])
        log(f"screen {wire}: {report[f'screen_{wire}']['ligands_per_s']:,.1f} ligands/s")
    report["csv_gate"] = csv_gate(scores["dense"], scores["sparse"])
    log(f"sparse CSV against dense: {report['csv_gate']}")

    packed, lib_names = load_library(work / "lib.npz")
    entries = built["entries"]
    indices = sorted(random.Random(0).sample(range(len(entries)),
                                             min(args.spot_checks, len(entries))))
    check = demo_real_screen.spot_check(
        PharmacophoreModel.load(str(built["model"])), entries, indices, scores["sparse"],
        dict(zip(lib_names, packed)), args.num_conformers, dev, args.embed_backend)
    report["spot_check"] = check
    log(f"spot checks against GraphMatcher: {check['checked']} checked, {check['failed']} "
        f"failed, largest difference {check['max_abs_diff']:.3g}")
    spot_gate(check)


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_sparse_wire", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
