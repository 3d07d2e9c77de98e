"""End-to-end demo on the PyTorch port: pocket modeling -> pharmacophore
model -> screening.

The counterpart of `end_to_end.py` with the same flags (plus `--device`):
a micro detector with random weights models a pocket, the pharmacophore
model screens a small generated library of .sdf files through the
overlapped executor, and the top hits print as CSV. Without `--protein`
the pocket is synthetic, with a ligand at its centre as the reference
(`synthetic.write_synthetic_site`), written into the output directory: a
cavity of 3 A in 1500 atoms within 24 A, so that the micro detector's
16^3 box (8 A a side) holds tokens.

    python examples/end_to_end_torch.py [--device cuda]

With the published checkpoint, give the real pocket and weights:

    python examples/end_to_end_torch.py --protein my.pdb --ref_ligand lig.sdf \
        --weights model.tar --full-arch
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pharmaconet_tpu_torch end-to-end demo")
    p.add_argument("--protein", default=None,
                   help="pocket PDB (default: a synthetic pocket written into --out_dir)")
    p.add_argument("--ref_ligand", default=None,
                   help="reference ligand (default: the synthetic pocket's ligand)")
    p.add_argument("--weights", default=None, help=".npz or upstream model.tar")
    p.add_argument("--out_dir", default="./result/end_to_end_torch")
    p.add_argument("--n_ligands", type=int, default=60)
    p.add_argument("--full-arch", action="store_true",
                   help="published 64^3 architecture (needs real weights to be meaningful)")
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device (cuda without a card raises)")
    return p


def main(args) -> int:
    import numpy as np

    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, PackedLigand
    from pharmaconet_tpu_torch.scoring.executor import ScreeningExecutor
    from pharmaconet_tpu_torch.scoring.ligand import Ligand
    from pharmaconet_tpu_torch.synthetic import _random_molecule, _to_sdf, write_synthetic_site

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    protein, ref_ligand = args.protein, args.ref_ligand
    if protein is None:
        protein, site_ligand = write_synthetic_site(
            out_dir / "site", cavity_radius=3.0, num_atoms=1500, outer_radius=24.0)
        ref_ligand = ref_ligand or site_ligand

    # 1. model the pocket
    if args.full_arch:
        pmnet = PharmacoNet(weight_path=args.weights, device=args.device)
    else:
        pmnet = PharmacoNet(
            weight_path=args.weights, score_threshold=0.0, verbose=False,
            max_hotspots=8, segmentation_chunk=4, grid_dim=16,
            model_kwargs=dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2),
                              window=2, token_feature_dim=16),
            device=args.device,
        )
        pmnet.focus_threshold = 0.0  # random micro weights: open the gate
    model = pmnet.run(protein, ref_ligand_path=ref_ligand)
    pm_path = out_dir / "pocket_model.pm"
    model.save(str(pm_path))
    print(f"pharmacophore model: {len(model.nodes)} nodes -> {pm_path}")

    # 2. generate a small ligand library (stand-in for your .sdf/.mol2 dir)
    lib_dir = out_dir / "library"
    lib_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(7)
    paths = []
    for i in range(args.n_ligands):
        elements, coords, bonds = _random_molecule(rng)
        p = lib_dir / f"lig_{i:03d}.sdf"
        p.write_text(_to_sdf(p.stem, elements, coords, bonds))
        paths.append(p)

    # 3. parse + pack once, screen through the overlapped executor
    packed = [PackedLigand.from_ligand(Ligand.load_from_file(p)) for p in paths]
    screener = BatchScreener(model, device=args.device)
    executor = ScreeningExecutor(screener, batch_size=32, pack_workers=2)
    scores = executor.score_packed(packed)

    ranked = sorted(zip(paths, scores), key=lambda x: x[1], reverse=True)
    csv = out_dir / "scores.csv"
    with open(csv, "w") as w:
        w.write("path,score\n")
        for p, s in ranked:
            w.write(f"{p},{s}\n")
    print(f"scored {len(ranked)} ligands -> {csv}")
    print(f"top {args.top}:")
    for p, s in ranked[: args.top]:
        print(f"  {s:10.4f}  {p.name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
