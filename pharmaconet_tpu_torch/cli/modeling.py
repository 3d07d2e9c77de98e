"""Pharmacophore modeling CLI on one torch device.

Flags, output naming and caching follow `pharmaconet_tpu`'s modeling CLI:
a protein PDB (-p) and a box centre (--center x y z, or the centroid of
--ref_ligand) give `<out_dir>/<prefix>_<x>_<y>_<z>_model.pm` (or
`<prefix>_<ligand stem>_model.pm`), reused unless --force, plus a PyMOL
visualization (.pse with pymol installed, a .pml script otherwise).
Modeling runs on --device (default cuda; asking for cuda without a
visible card is an error, never a quiet move to the CPU).

  python -m pharmaconet_tpu_torch.cli.modeling -p pocket.pdb --center 1.0 2.0 3.0 \\
      --prefix pocket --weight_path model.tar --device cuda
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

SUCCESS, EXIT, FAIL = 0, 1, 2
PRECISIONS = ("float32", "tensorfloat32", "bfloat16")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "pharmacophore modeling script",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    cfg = parser.add_argument_group("config")
    cfg.add_argument("--pdb", type=str, help="RCSB PDB code (not yet ported)")
    cfg.add_argument("-p", "--protein", type=str, help="custom path of protein pdb file (.pdb)")
    cfg.add_argument("--out_dir", type=str, help="output directory. default: ./result/{prefix}")
    cfg.add_argument("--prefix", type=str, help="task name. default: the protein file's stem")
    cfg.add_argument("--suffix", choices=("pm", "json"), default="pm", help="model file extension")

    env = parser.add_argument_group("environment")
    env.add_argument("--weight_path", type=str,
                     help="checkpoint: upstream torch model.tar or the JAX package's .npz")
    env.add_argument("--force", action="store_true", help="overwrite existing outputs")
    env.add_argument("--segmentation_precision", choices=PRECISIONS, default="tensorfloat32",
                     help="mask-decoder precision; tensorfloat32 matches the upstream "
                          "network's own GPU convolutions (cudnn allow_tf32=True)")
    env.add_argument("--precision", choices=PRECISIONS, default="float32",
                     help="trunk and cavity/token head precision")
    env.add_argument("--device", type=str, default="cuda",
                     help="torch device that models (cuda, cuda:N, or cpu)")
    env.add_argument("--profile", type=str, metavar="DIR", help="device trace (not yet ported)")
    env.add_argument("--shard", action="store_true", help="multi-device modeling (not yet ported)")
    env.add_argument("-v", "--verbose", action="store_true", help="verbose")

    adv = parser.add_argument_group("advanced")
    adv.add_argument("--ref_ligand", type=str, help="ligand defining the box center (.sdf/.pdb/.mol2)")
    adv.add_argument("--center", nargs="+", type=float, help="box center coordinates")
    return parser


def main(args) -> int:
    for flag, name in ((args.pdb, "--pdb"), (args.shard, "--shard"), (args.profile, "--profile")):
        if flag:
            print(f"{name} is not yet ported to pharmaconet_tpu_torch", file=sys.stderr)
            return FAIL
    if args.protein is None:
        print("missing protein: -p/--protein", file=sys.stderr)
        return FAIL
    if args.ref_ligand is None and args.center is None:
        print("give the box centre with --center x y z or --ref_ligand: detecting ligands "
              "in the PDB is not yet ported to pharmaconet_tpu_torch", file=sys.stderr)
        return FAIL

    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.utils import visualize

    protein_path = args.protein
    assert os.path.exists(protein_path), protein_path
    prefix = args.prefix or Path(protein_path).stem
    save_dir = Path(args.out_dir) if args.out_dir else Path("./result") / prefix
    save_dir.mkdir(exist_ok=True, parents=True)

    if args.ref_ligand is not None:
        assert os.path.exists(args.ref_ligand), args.ref_ligand
        filename, center = f"{prefix}_{Path(args.ref_ligand).stem}_model", None
    else:
        assert len(args.center) == 3, "--center takes 3 coordinates"
        x, y, z = args.center
        filename, center = f"{prefix}_{x}_{y}_{z}_model", (x, y, z)

    model_path = save_dir / f"{filename}.{args.suffix}"
    if (not args.force) and model_path.exists():
        logging.warning(f"Modeling pass - {model_path} exists")
        model = PharmacophoreModel.load(str(model_path))
    else:
        module = PharmacoNet(weight_path=args.weight_path, matmul_precision=args.precision,
                             segmentation_precision=args.segmentation_precision,
                             device=args.device, verbose=args.verbose)
        logging.info("Load PharmacoNet finish")
        logging.info(f"Load {protein_path}")
        model = module.run(protein_path, ref_ligand_path=args.ref_ligand, center=center)
        model.save(str(model_path))
        logging.info(f"Save pharmacophore model to {model_path}")
    written = visualize.visualize_single(model, protein_path, args.ref_ligand, prefix,
                                         str(save_dir / f"{filename}_pymol.pse"))
    logging.info(f"Save visualization to {written}")
    return SUCCESS


def entrypoint() -> int:
    args = build_parser().parse_args()
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    return main(args)


if __name__ == "__main__":
    raise SystemExit(entrypoint())
