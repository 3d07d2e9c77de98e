"""Where K6's time goes: the voxelizer's second design split into its two
launches on the card, at the modeling path's shape (the seed-0 synthetic
pocket, 3005 atoms in the 4096 bucket, 64^3 grid):

  k6        the wrapper, `voxelize_cuda.voxelize_pallas` (both launches)
  bin       phase 1 alone: the atoms binned by x column
  tile      phase 2 alone, on phase 1's lists
  store     phase 2 on empty lists: the zeroed tile images and occupancy
            leaving the card's memory, the floor of this tiling
  baseline  the first design, `voxelize_pallas_baseline`

`k6` is first held bit for bit against the baseline. The kinds are timed
in turn over three rounds (probes/timing.py); the last line is one JSON
object of launch counts and times. Needs a card (there is no kernel to
split on the CPU).

    python -m pharmaconet_tpu_torch.probes.probe_voxelize
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import torch

from .. import constants as C
from ..device import resolve_device
from ..ops import voxelize_cuda
from . import device_line
from .timing import time_rounds

POCKET_SEED = 0


def pocket_atoms(device: torch.device) -> list[torch.Tensor]:
    """The padded atom arrays and centre of the seed-0 synthetic pocket, as
    the modeling path parses them."""
    from ..module import PharmacoNet
    from ..synthetic import write_synthetic_pocket

    with tempfile.TemporaryDirectory() as tmp:
        pdb = Path(tmp) / "pocket.pdb"
        info = write_synthetic_pocket(pdb, seed=POCKET_SEED)
        net = SimpleNamespace(grid_dim=C.GRID_DIM, get_center=PharmacoNet.get_center)
        data = PharmacoNet.parse(net, pdb, center=info["center"])
    return [torch.from_numpy(a).to(device) for a in (
        data.atom_positions, data.atom_features, data.atom_valid, data.center)]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="a CUDA device (default cuda)")
    dev = resolve_device(parser.parse_args(argv).device)
    if dev.type != "cuda":
        print("probe_voxelize: splits the CUDA kernel's launches; needs a card", file=sys.stderr)
        return 2
    print(device_line(dev), flush=True)
    args = pocket_atoms(dev)
    a, dim, res = args[0].shape[0], C.GRID_DIM, C.GRID_RESOLUTION
    lib = voxelize_cuda.load_library()
    radii = voxelize_cuda._radii(res, dim, C.FEATURE_RADII, C.MASK_RADII, C.VOXELIZER_SIGMA)
    image = torch.empty((dim, dim, dim, voxelize_cuda.NUM_CHANNELS), device=dev)
    occ = torch.empty((dim, dim, dim), dtype=torch.bool, device=dev)
    lists = torch.empty((dim, a, 4), device=dev)
    counts = torch.empty((dim,), dtype=torch.int32, device=dev)
    empty = torch.zeros_like(counts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pos, feats, valid, center = (t.data_ptr() for t in args)

    def bin_phase():
        lib.voxelize_bin_launch(pos, valid, center, lists.data_ptr(), counts.data_ptr(), a, dim,
                                res, radii[0], radii[4], stream)

    def tile_phase(n=counts):
        lib.voxelize_tile_launch(lists.data_ptr(), n.data_ptr(), feats, center,
                                 image.data_ptr(), occ.data_ptr(), a, dim, res, *radii, stream)

    img, occupancy = voxelize_cuda.voxelize_pallas(*args)
    base_img, base_occ = voxelize_cuda.voxelize_pallas_baseline(*args)
    bin_phase()
    tile_phase()
    torch.cuda.synchronize()
    same = torch.equal(img, base_img) and torch.equal(occupancy, base_occ)
    same = same and torch.equal(image, img) and torch.equal(occ, occupancy)
    print(f"atoms={int(args[2].sum())} (bucket {a}) grid={dim}^3 column entries="
          f"{int(counts.sum())} (longest {int(counts.max())}); bit-equal to the first design "
          f"(and the phases run alone to the wrapper): {same}", flush=True)
    if not same:
        return 1
    times = time_rounds(dev, {
        "k6": lambda: voxelize_cuda.voxelize_pallas(*args), "bin": bin_phase, "tile": tile_phase,
        "store": lambda: tile_phase(empty),
        "baseline": lambda: voxelize_cuda.voxelize_pallas_baseline(*args)})
    for kind, t in times.items():
        print(f"{kind}: {t.stream_ms:.4f} ms back to back (enqueue {t.enqueue_ms:.4f} ms"
              f"{'' if t.gapless else ', NOT gapless'}), one call {t.ms:.4f} ms", flush=True)
    print(json.dumps({"probe": "probe_voxelize", "device": str(dev),
                      "launches": dict(voxelize_cuda.LAUNCHES),
                      "times": {k: t.as_dict() for k, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
