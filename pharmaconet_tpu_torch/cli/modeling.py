"""Pharmacophore modeling CLI on one torch device.

Flags, output naming, caching and ligand detection follow
`pharmaconet_tpu`'s modeling CLI. The protein is a local PDB (-p) or an
RCSB entry (--pdb, downloaded once to <out_dir>/<prefix>.pdb). The box
centre is --center x y z, the centroid of --ref_ligand, or, by default, a
HET ligand of the PDB: one ligand is modelled directly; several are chosen
with --ligand_id / --chain, all with --all, or interactively; with no
ligand the centre is asked for. Each site gives
`<out_dir>/<prefix>_<chain>_<ligand id>_model.pm` (`<prefix>_<x>_<y>_<z>_model.pm`
for a centre, `<prefix>_<ligand stem>_model.pm` for --ref_ligand), reused
unless --force, plus a PyMOL visualization (.pse with pymol installed, a
.pml script otherwise). Modeling runs on --device (default cuda; asking
for cuda without a visible card is an error, never a quiet move to the
CPU). --shard, with --device cuda and more than one visible card, fans
each pocket's segmentation over the cards (`parallel.modeling.ShardedSegmenter`)
and, with --all, models the sites that are not cached one pocket per card
(`ShardedModeler.run_batch`); with one card it runs there. --profile DIR
writes a torch.profiler trace of the modeling to DIR (`utils.profiling.trace`).

  python -m pharmaconet_tpu_torch.cli.modeling -p pocket.pdb --center 1.0 2.0 3.0 \\
      --prefix pocket --weight_path model.tar --device cuda
  python -m pharmaconet_tpu_torch.cli.modeling -p complex.pdb --ligand_id LIG --device cuda
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
    cfg.add_argument("--pdb", type=str, help="RCSB PDB code")
    cfg.add_argument("-l", "--ligand_id", type=str, help="RCSB ligand code")
    cfg.add_argument("-p", "--protein", type=str, help="custom path of protein pdb file (.pdb)")
    cfg.add_argument("-c", "--chain", type=str, help="chain")
    cfg.add_argument("-a", "--all", action="store_true", help="use all binding sites")
    cfg.add_argument("--out_dir", type=str, help="output directory. default: ./result/{prefix}")
    cfg.add_argument("--prefix", type=str,
                     help="task name. default: the PDB code or the protein file's stem")
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
    env.add_argument("--profile", type=str, metavar="DIR",
                     help="write a torch.profiler trace of the modeling run to DIR "
                          "(view with TensorBoard or Perfetto)")
    env.add_argument("--shard", action="store_true",
                     help="use every visible card: with --all and several uncached sites, "
                          "one pocket per card (ShardedModeler); otherwise each pocket's "
                          "hotspots fan out over the cards (ShardedSegmenter)")
    env.add_argument("-v", "--verbose", action="store_true", help="verbose")

    adv = parser.add_argument_group("advanced")
    adv.add_argument("--ref_ligand", type=str, help="ligand defining the box center (.sdf/.pdb/.mol2)")
    adv.add_argument("--center", nargs="+", type=float, help="box center coordinates")
    return parser


def _ask_center() -> tuple[float, float, float] | None:
    try:
        return tuple(float(input(f"{axis}: ")) for axis in "xyz")
    except (EOFError, ValueError):
        return None


def _modeling_mesh(args):
    """The devices --shard spreads over (`parallel.mesh.visible_mesh`), or None."""
    from pharmaconet_tpu_torch.parallel.mesh import visible_mesh

    return visible_mesh(args.device)


def main(args) -> int:
    if args.pdb is None and args.protein is None:
        print("missing protein: --pdb or -p/--protein", file=sys.stderr)
        return FAIL

    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.parallel.modeling import ShardedModeler, ShardedSegmenter
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.utils import profiling, visualize
    from pharmaconet_tpu_torch.utils.rcsb import download_pdb, parse_pdb

    prefix = args.prefix or args.pdb or Path(args.protein).stem
    save_dir = Path(args.out_dir) if args.out_dir else Path("./result") / prefix
    save_dir.mkdir(exist_ok=True, parents=True)

    if args.pdb is not None:
        protein_path = str(save_dir / f"{prefix}.pdb")
        if not os.path.exists(protein_path):
            logging.info(f"Download {args.pdb} to {protein_path}")
            if not download_pdb(args.pdb, protein_path):
                print(f"download of {args.pdb} failed", file=sys.stderr)
                return FAIL
    else:
        protein_path = args.protein
        assert os.path.exists(protein_path), protein_path
    logging.info(f"Load {protein_path}")

    mesh = _modeling_mesh(args) if args.shard else None
    if args.shard and mesh is None:
        logging.info("--shard requested but only one device is visible; running single-device")
    module = runner = None  # built once, at the first site that is not cached

    def network():
        nonlocal module, runner
        if module is None:
            module = PharmacoNet(weight_path=args.weight_path, matmul_precision=args.precision,
                                 segmentation_precision=args.segmentation_precision,
                                 device=args.device, verbose=args.verbose)
            logging.info("Load PharmacoNet finish")
            runner = module
            if mesh is not None:
                runner = ShardedSegmenter(module, mesh=mesh)
                logging.info(f"Sharding hotspot segmentation over {len(mesh)} devices")
        return module

    def profiled(fn):
        if not args.profile:
            return fn()
        with profiling.trace(args.profile):
            out = fn()
        logging.info(f"Wrote device trace to {args.profile}")
        return out

    def run_pmnet(filename, ligand_path=None, center=None, model=None) -> PharmacophoreModel:
        model_path = save_dir / f"{filename}.{args.suffix}"
        if model is not None:  # modeled by the batched mesh path
            model.save(str(model_path))
            logging.info(f"Save pharmacophore model to {model_path}")
        elif (not args.force) and model_path.exists():
            logging.warning(f"Modeling pass - {model_path} exists")
            model = PharmacophoreModel.load(str(model_path))
        else:
            network()
            model = profiled(lambda: runner.run(protein_path, ref_ligand_path=ligand_path,
                                                center=center))
            model.save(str(model_path))
            logging.info(f"Save pharmacophore model to {model_path}")
        written = visualize.visualize_single(model, protein_path, ligand_path, prefix,
                                             str(save_dir / f"{filename}_pymol.pse"))
        logging.info(f"Save visualization to {written}")
        return model

    def run_site(inform, model=None) -> PharmacophoreModel:
        return run_pmnet(f"{prefix}_{inform.pdbchain}_{inform.id}_model", inform.file_path,
                         inform.center, model=model)

    if args.ref_ligand is not None:
        assert os.path.exists(args.ref_ligand), args.ref_ligand
        run_pmnet(f"{prefix}_{Path(args.ref_ligand).stem}_model", ligand_path=args.ref_ligand)
        return SUCCESS

    if args.center is not None:
        assert len(args.center) == 3, "--center takes 3 coordinates"
        x, y, z = args.center
        run_pmnet(f"{prefix}_{x}_{y}_{z}_model", center=(x, y, z))
        return SUCCESS

    informs = parse_pdb(prefix, protein_path, save_dir)
    if not informs:
        logging.warning("No ligand detected — enter the binding-site center:")
        center = _ask_center()
        if center is None:
            print("no ligand detected and no centre given: pass --center x y z or --ref_ligand",
                  file=sys.stderr)
            return FAIL
        x, y, z = center
        run_pmnet(f"{prefix}_{x}_{y}_{z}_model", center=center)
        return SUCCESS

    if args.all:
        logging.info("Use all binding sites (-a | --all)")
        # --shard with several uncached sites: one pocket per device
        # (ShardedModeler.run_batch); cached sites stay out of the batch
        keys = [f"{prefix}_{i.pdbchain}_{i.id}" for i in informs]
        todo = [(k, i) for k, i in zip(keys, informs)
                if args.force or not (save_dir / f"{k}_model.{args.suffix}").exists()]
        batched = {}
        if mesh is not None and len(todo) > 1:
            logging.info(f"Batch-modeling {len(todo)} sites over {len(mesh)} devices")
            modeler = ShardedModeler(network(), mesh=mesh)
            models = profiled(lambda: modeler.run_batch(
                [(protein_path, i.file_path, i.center) for _, i in todo]))
            batched = {k: m for (k, _), m in zip(todo, models)}
        model_dict = {k: (run_site(i, model=batched.get(k)), i.file_path)
                      for k, i in zip(keys, informs)}
        written = visualize.visualize_multiple(model_dict, protein_path, prefix,
                                               str(save_dir / f"{prefix}.pse"))
        logging.info(f"Save combined visualization to {written}")
        return SUCCESS

    text = "\n\n".join(str(i) for i in informs)
    logging.info(f"A total of {len(informs)} ligand(s) detected!\n{text}\n")

    if args.ligand_id is not None or args.chain is not None:
        informs = [
            i for i in informs
            if (args.ligand_id is None or args.ligand_id.upper() == i.id)
            and (args.chain is None or args.chain.upper() in (i.pdbchain, i.authchain))
        ]
        if not informs:
            logging.warning("No matching pattern!")
            return FAIL

    if len(informs) == 1:
        run_site(informs[0])
        return SUCCESS

    inform_by_order = {str(i.order): i for i in informs}
    logging.info("Select ligand number(s) (e.g. 1 ; 1,3 ; all ; exit)")
    while True:
        try:
            answer = input("ligand number: ").strip()
        except EOFError:
            return EXIT
        if answer in ("all", "exit"):
            break
        if all(n.strip() in inform_by_order for n in answer.split(",")):
            break
        logging.warning(f"Invalid selection: {answer}")
    if answer == "exit":
        return EXIT
    selected = informs if answer == "all" else [inform_by_order[n.strip()]
                                                for n in answer.split(",")]
    for inform in selected:
        run_site(inform)
    return SUCCESS


def entrypoint() -> int:
    args = build_parser().parse_args()
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    return main(args)


if __name__ == "__main__":
    raise SystemExit(entrypoint())
