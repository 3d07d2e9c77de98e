"""Pocket feature-extraction CLI on one torch device.

Upstream feature_extraction.py:8-76 and `pharmaconet_tpu`'s CLI of the
same name: saves [multi_scale_features, hotspot_infos] as .npz, or as a
torch .pt object when the output path ends with .pt. Runs on --device
(default cuda; asking for cuda without a visible card is an error).

  python -m pharmaconet_tpu_torch.cli.feature_extraction -p pocket.pdb \\
      --center 1.0 2.0 3.0 -o features.npz --weight_path model.tar --device cuda

Output contents:
  multi_scale_features: 5 arrays, channel-last
      [1,4,4,4,96], [1,8,8,8,96], [1,16,16,16,96], [1,32,32,32,96],
      [1,64,64,64,96]
  hotspot_infos: per hotspot — 192-d feature, position, score in [0,1],
      nci_type (10 classes), hotspot_type / point_type (7 classes)
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "PharmacoNet feature extraction",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-p", "--protein", type=str, required=True, help="protein pdb path")
    parser.add_argument("-o", "--out", type=str, required=True,
                        help="feature save path (.npz | .pt)")
    parser.add_argument("--ref_ligand", type=str, help="ligand defining the box center")
    parser.add_argument("--center", nargs="+", type=float, help="box center coordinates")
    parser.add_argument("--weight_path", type=str, help="custom weight path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device that runs the network (cuda, cuda:N, or cpu)")
    return parser


def main(args) -> int:
    import torch

    from pharmaconet_tpu_torch.api import get_pmnet_dev

    module = get_pmnet_dev(device=args.device, weight_path=args.weight_path)
    center = tuple(args.center) if args.center else None
    features, hotspot_infos = module.feature_extraction(args.protein, args.ref_ligand, center)

    if args.out.endswith(".pt"):
        torch_features = [torch.from_numpy(np.asarray(f)) for f in features]
        torch_infos = [
            {**info, "hotspot_feature": torch.from_numpy(np.asarray(info["hotspot_feature"]))}
            for info in hotspot_infos
        ]
        torch.save([torch_features, torch_infos], args.out)
    else:
        payload = {f"feature_{i}": np.asarray(f) for i, f in enumerate(features)}
        payload["num_hotspots"] = np.asarray(len(hotspot_infos))
        for i, info in enumerate(hotspot_infos):
            payload[f"hotspot_{i}_feature"] = np.asarray(info["hotspot_feature"])
            payload[f"hotspot_{i}_position"] = np.asarray(info["hotspot_position"])
            payload[f"hotspot_{i}_score"] = np.asarray(info["hotspot_score"])
            payload[f"hotspot_{i}_nci_type"] = np.asarray(info["nci_type"])
        np.savez_compressed(args.out, **payload)
    print(f"saved {len(features)} feature scales + {len(hotspot_infos)} hotspots to {args.out}")
    return 0


def entrypoint() -> int:
    return main(build_parser().parse_args())


if __name__ == "__main__":
    raise SystemExit(entrypoint())
