"""Prepack a ligand library for repeated screening runs.

Two levels of prepacking, in the formats `pharmaconet_tpu` writes:

1. Model-independent packed library (.npz): parse + perceive every
   .sdf/.mol2 under a directory once; screening then starts at the device
   phase.
2. Model-specific tile store (--tiles_out, needs -p): additionally pack
   the library for one pharmacophore model and store the final device
   arrays + host-tail metadata on disk (scoring/tiled_store.py).
   `screening --library_tiles` then skips the per-batch host pack. v3
   stores (the default) bake the assignment-tree leaves, on --device.

  python -m pharmaconet_tpu_torch.cli.prepack -d ligands/ -o lib.npz
  python -m pharmaconet_tpu_torch.cli.prepack --library lib.npz -p model.pm \\
      --tiles_out tiles/ --device cuda
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "prepack", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("-d", "--library_dir", type=str,
                        help="ligand file directory (.sdf/.mol2)")
    parser.add_argument("--library", type=str,
                        help="existing packed library (.npz) to start from "
                             "(instead of -d)")
    parser.add_argument("--smiles", type=str,
                        help="SMILES library file (not yet ported)")
    parser.add_argument("-o", "--out", type=str,
                        help="output packed library (.npz)")
    parser.add_argument("--num_conformers", type=int, default=None,
                        help="cap conformers per ligand")
    parser.add_argument("--cpus", type=int, default=1,
                        help="worker processes for parsing")

    tiles = parser.add_argument_group("tile store (model-specific)")
    tiles.add_argument("--tiles_out", type=str,
                       help="write a screen-ready tile store directory")
    tiles.add_argument("-p", "--pharmacophore_model", type=str,
                       help="pharmacophore model (.pm|.json) the tile store "
                            "is packed for")
    tiles.add_argument("--batch_size", type=int, default=2048,
                       help="ligands per stored batch")
    tiles.add_argument("--pack_threads", type=int, default=1,
                       help="host threads for the native tile packer")
    tiles.add_argument("--leaf_wire", type=str, default="sparse",
                       choices=("dense", "sparse"),
                       help="baked-leaf on-disk/wire format (v3 stores): "
                            "'sparse' ships set-bit indices, 'dense' "
                            "bit-planes; scores are equal")
    tiles.add_argument("--tiles_version", type=int, default=3, choices=(2, 3),
                       help="store layout: 3 = block-major + deduplicated "
                            "group tables (K2), 2 = row-expanded Gaussian "
                            "tables + stored distances (K3)")
    tiles.add_argument("--device", type=str, default="cuda",
                       help="torch device of the v3 leaf bake (cuda, cuda:N, "
                            "or cpu)")

    param = parser.add_argument_group("screening weights (baked into tiles)")
    param.add_argument("--hydrophobic", type=float, default=1.0)
    param.add_argument("--aromatic", type=float, default=4.0)
    param.add_argument("--hba", type=float, default=4.0)
    param.add_argument("--hbd", type=float, default=4.0)
    param.add_argument("--halogen", type=float, default=4.0)
    param.add_argument("--anion", type=float, default=8.0)
    param.add_argument("--cation", type=float, default=8.0)
    return parser


def main(args) -> int:
    if args.smiles:
        print("--smiles is not yet ported to pharmaconet_tpu_torch", file=sys.stderr)
        return 2
    from pharmaconet_tpu_torch.scoring.library import (
        build_library_from_files,
        load_library,
        save_library,
    )

    if args.library:
        packed, names = load_library(args.library)
        print(f"loaded {len(packed)} prepacked ligands from {args.library}")
    elif args.library_dir:
        library = Path(args.library_dir)
        files = sorted(library.rglob("*.sdf")) + sorted(library.rglob("*.mol2"))
        print(f"packing {len(files)} ligand files ...")
        packed, names = build_library_from_files(
            files, args.num_conformers, cpus=args.cpus
        )
    else:
        print("provide -d/--library_dir or --library", file=sys.stderr)
        return 2
    if not (args.out or args.tiles_out):
        print("nothing to do: provide -o and/or --tiles_out", file=sys.stderr)
        return 2
    if args.tiles_out and not args.pharmacophore_model:
        print("--tiles_out needs -p/--pharmacophore_model (tile stores are "
              "model-specific)", file=sys.stderr)
        return 2
    if args.out:
        save_library(args.out, packed, names)
        print(f"packed {len(packed)} ligands -> {args.out}")

    if args.tiles_out:
        from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
        from pharmaconet_tpu_torch.scoring.batch_screen import PackedModel
        from pharmaconet_tpu_torch.scoring.tiled_store import (
            write_tiled_store,
            write_v3_store,
        )

        weights = dict(
            Cation=args.cation, Anion=args.anion, Aromatic=args.aromatic,
            HBond_donor=args.hbd, HBond_acceptor=args.hba,
            Halogen=args.halogen, Hydrophobic=args.hydrophobic,
        )
        model = PackedModel.from_model(
            PharmacophoreModel.load(args.pharmacophore_model), weights
        )
        if args.tiles_version == 3:
            meta = write_v3_store(
                args.tiles_out, model, packed, names,
                batch_size=args.batch_size, threads=args.pack_threads,
                leaf_wire=args.leaf_wire, device=args.device,
            )
        else:
            meta = write_tiled_store(
                args.tiles_out, model, packed, names,
                batch_size=args.batch_size, threads=args.pack_threads,
            )
        shape = (
            f"T {meta['t']}, mn_cap {meta['mn_cap']}"
            if meta["version"] == 3 else f"width {meta['width']}"
        )
        print(
            f"tile store v{meta['version']}: {meta['n_batches']} batches of "
            f"{meta['batch_size']} ({shape}, cmax {meta['cmax']}) "
            f"-> {args.tiles_out}"
        )
    return 0


def entrypoint() -> int:
    return main(build_parser().parse_args())


if __name__ == "__main__":
    raise SystemExit(entrypoint())
