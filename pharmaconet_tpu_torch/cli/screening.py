"""Virtual screening CLI on one torch device.

Flags, library discovery and CSV output follow `pharmaconet_tpu`'s
screening CLI. Ligands come from a directory of .sdf/.mol2 files (-d),
parsed and packed on the host, from a prepacked .npz library (--library),
whose batches stream through the overlapped executor, from a SMILES file
(--smiles: conformers embedded in-house, on --device with --cpus 1, then
packed in memory and screened as --library is), or from a model-specific
tile store (--library_tiles, written by `prepack --tiles_out`), whose
batches go straight to the kernels. Scoring runs on --device (default
cuda; asking for cuda without a visible card is an error, never a quiet
move to the CPU).

  python -m pharmaconet_tpu_torch.cli.screening -p model.pm --library lib.npz \\
      -o out.csv --device cuda
  python -m pharmaconet_tpu_torch.cli.screening -p model.pm --library_tiles tiles/ \\
      -o out.csv --device cuda
  python -m pharmaconet_tpu_torch.cli.screening -p model.pm --smiles lib.smi \\
      -o out.csv --device cuda
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "scoring", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    cfg = parser.add_argument_group("config")
    cfg.add_argument("-p", "--pharmacophore_model", type=str, required=True,
                     help="path of pharmacophore model (.pm | .json)")
    cfg.add_argument("-d", "--library_dir", type=str,
                     help="molecular library directory path (.sdf/.mol2 files)")
    cfg.add_argument("--library", type=str,
                     help="prepacked ligand library (.npz from prepack)")
    cfg.add_argument("--library_tiles", type=str,
                     help="model-specific tile store directory (prepack "
                          "--tiles_out; skips the host pack)")
    cfg.add_argument("--smiles", type=str,
                     help="SMILES library file ('SMILES [name]' per line); "
                          "conformers embedded in-house, on --device when "
                          "--cpus is 1 (prefer prepack --smiles for "
                          "repeated screens)")
    cfg.add_argument("--num_conformers", type=int, default=8,
                     help="conformers to embed per SMILES (--smiles only)")
    cfg.add_argument("-o", "--out", type=str, required=True, help="result CSV path")
    cfg.add_argument("--batch_size", type=int, default=1024, help="ligands per device batch")
    cfg.add_argument("--cpus", type=int, default=1,
                     help="worker processes for ligand file parsing (scoring runs on device)")
    cfg.add_argument("--pack_threads", type=int, default=0,
                     help="host threads for the native batch packer "
                          "(0 = one per CPU)")
    cfg.add_argument("--device", type=str, default="cuda",
                     help="torch device that scores (cuda, cuda:N, or cpu)")

    param = parser.add_argument_group("parameter")
    param.add_argument("--hydrophobic", type=float, default=1.0, help="weight for hydrophobic carbon")
    param.add_argument("--aromatic", type=float, default=4.0, help="weight for aromatic ring")
    param.add_argument("--hba", type=float, default=4.0, help="weight for hbond acceptor")
    param.add_argument("--hbd", type=float, default=4.0, help="weight for hbond donor")
    param.add_argument("--halogen", type=float, default=4.0, help="weight for halogen atom")
    param.add_argument("--anion", type=float, default=8.0, help="weight for anion")
    param.add_argument("--cation", type=float, default=8.0, help="weight for cation")
    return parser


def load_partial(partial_path: Path, names: list[str]) -> dict[int, float]:
    """Scores already written to <out>.partial by an interrupted run
    (one "index,name,score" line per ligand, keyed by library index so
    duplicate names stay distinct). A torn last line is skipped, and that
    ligand is simply scored again."""
    done: dict[int, float] = {}
    if partial_path.exists():
        for line in partial_path.read_text().splitlines():
            try:
                idx_s, rest = line.split(",", 1)
                name, score_s = rest.rsplit(",", 1)
                idx, score = int(idx_s), float(score_s)
            except ValueError:
                continue
            if 0 <= idx < len(names) and names[idx] == name:
                done[idx] = score  # index+name match ⇒ same library
        print(f"resuming: {len(done)} ligands already scored in {partial_path}")
    return done


def screen_tiles(screener, store_path: str, out: str) -> list[tuple[str, float]]:
    """Screen every batch of a tile store; returns (name, score) in
    library order. Batch i+1 is dispatched (asynchronous on the card)
    before batch i's host tail runs, and a prefetch thread pages batch
    i+1 in from disk meanwhile. Scores append to <out>.partial as batches
    complete; a rerun skips the ligands already there."""
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore

    store = TiledStore(store_path, screener.packed_model)
    names = store.names()
    print(f"tile store: {store.n_ligands} ligands in {store.n_batches} batches")

    partial_path = Path(out + ".partial")
    done = load_partial(partial_path, names)
    results = [(names[i], s) for i, s in done.items()]
    todo = [
        bi for bi in range(store.n_batches)
        if not all(i in done for i in range(bi * store.batch_size,
                                            min((bi + 1) * store.batch_size, store.n_ligands)))
    ]
    with open(partial_path, "a") as partial:

        def emit(sb, result, base):
            scores = (screener.postprocess_stored(sb, result)
                      if result is not None else [0.0] * sb.batch_len)
            for j, score in enumerate(scores):
                if base + j not in done:
                    partial.write(f"{base + j},{names[base + j]},{score}\n")
                    results.append((names[base + j], score))
            partial.flush()

        pending = None
        for bi, sb in store.iter_loaded(todo):
            result = None if sb.empty else screener.dispatch_stored(sb)
            if pending is not None:
                emit(*pending)
            pending = (sb, result, bi * store.batch_size)
        if pending is not None:
            emit(*pending)
    partial_path.unlink()  # complete: the sorted CSV is the record
    return results


def main(args) -> int:
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.ligand import Ligand

    model = PharmacophoreModel.load(args.pharmacophore_model)
    weights = dict(
        Cation=args.cation,
        Anion=args.anion,
        Aromatic=args.aromatic,
        HBond_donor=args.hbd,
        HBond_acceptor=args.hba,
        Halogen=args.halogen,
        Hydrophobic=args.hydrophobic,
    )
    pack_threads = args.pack_threads or os.cpu_count() or 1
    screener = BatchScreener(model, weights, pack_threads=pack_threads,
                             device=args.device)

    results: list[tuple[str, float]] = []
    if args.library_tiles:
        results = screen_tiles(screener, args.library_tiles, args.out)
    elif args.library or args.smiles:
        # prepacked library: skip parsing/perception entirely; the executor
        # overlaps C++ packing (GIL-released worker threads) with device
        # dispatch + host postprocessing, preserving score order. Batch
        # results append to <out>.partial as they complete; rerunning the
        # same command skips ligands already scored there. --smiles builds
        # the same packed form in memory (embed + perceive once up front),
        # then screens identically.
        from pharmaconet_tpu_torch.scoring.executor import ScreeningExecutor
        from pharmaconet_tpu_torch.scoring.library import (
            build_library_from_smiles,
            load_library,
        )

        if args.library:
            packed, names = load_library(args.library)
            print(f"loaded {len(packed)} prepacked ligands")
        else:
            packed, names = build_library_from_smiles(
                args.smiles, num_conformers=args.num_conformers, cpus=args.cpus,
                device=args.device,
            )
            print(f"embedded + packed {len(packed)} SMILES")

        partial_path = Path(args.out + ".partial")
        done = load_partial(partial_path, names)
        todo = [
            (i, p, n)
            for i, (p, n) in enumerate(zip(packed, names))
            if i not in done
        ]
        results.extend((names[i], s) for i, s in done.items())

        with open(partial_path, "a") as partial:
            todo_keys = [(i, n) for i, _, n in todo]

            def stream(start, scores):
                for (idx, name), score in zip(todo_keys[start : start + len(scores)], scores):
                    partial.write(f"{idx},{name},{score}\n")
                    results.append((name, score))
                partial.flush()

            executor = ScreeningExecutor(
                screener, batch_size=args.batch_size,
                pack_workers=max(1, min(4, pack_threads)),
            )
            executor.score_packed([p for _, p, _ in todo], on_batch=stream)
        partial_path.unlink()  # complete: the sorted CSV is the record
    else:
        if not args.library_dir:
            print("provide -d/--library_dir, --library, --library_tiles or --smiles",
                  file=sys.stderr)
            return 2
        from pharmaconet_tpu_torch.scoring.parse_pool import iter_parsed

        library = Path(args.library_dir)
        files = sorted(library.rglob("*.sdf")) + sorted(library.rglob("*.mol2"))
        print(f"find {len(files)} molecules")

        batch_files: list[str] = []
        batch_ligands: list[Ligand] = []

        def flush():
            if not batch_ligands:
                return
            scores = screener.score_ligands(batch_ligands)
            results.extend(zip(batch_files, scores))
            batch_files.clear()
            batch_ligands.clear()

        for path_str, ligand in iter_parsed(files, cpus=args.cpus):
            batch_ligands.append(ligand)
            batch_files.append(path_str)
            if len(batch_ligands) >= args.batch_size:
                flush()
        flush()

    results.sort(key=lambda x: x[1], reverse=True)
    with open(args.out, "w") as w:
        w.write("path,score\n")
        for filename, score in results:
            w.write(f"{filename},{score}\n")
    return 0


def entrypoint() -> int:
    return main(build_parser().parse_args())


if __name__ == "__main__":
    raise SystemExit(entrypoint())
