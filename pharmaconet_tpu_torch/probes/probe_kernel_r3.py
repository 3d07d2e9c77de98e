"""Probe P4: K1's function in design variants
(`score_tiles_fused_variant`), each held against `full` (max |diff| and
the count of -1 mismatches, within rtol 2e-5 / atol 1e-4 and no
mismatch) before the modes are timed in turn over three rounds (median):

  full    K1 (fused_stream_kernel)
  b4d     the TPU variant without the [P*C, TILE] broadcast copies; a
          thread per row builds none, so on the card it is K1's own code
  ohbf16  K1 with the node positions selected on the tensor cores (exact
          three-way bf16 split, unsigned one-hots, wgmma), rows and
          distances bit-equal to K1's

So the modes differ from K1 in the selection alone. The first ohbf16
design (mma.sync inside K1's first design) stays launchable as
`screen_cuda.score_tiles_ohbf16_baseline`; chip_smoke.py times it beside
ohbf16.

The counterpart of the repo's probes/probe_kernel_r3.py.

    python -m pharmaconet_tpu_torch.probes.probe_kernel_r3 [--device cuda|cpu] [--ligands 2048]
"""

from __future__ import annotations

import sys

import torch

from ..ops import screen_cuda
from ..ops.screen_ref import VARIANTS
from . import agreement, device_line, launch_line, parse_args, prep, time_line
from .timing import time_rounds

KERNELS = ("score_tiles_fused_variant",)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(__doc__.splitlines()[0], argv)
    dev = args.device
    print(device_line(dev), flush=True)
    pm, ligands = prep.headline_inputs(args.ligands)
    ti = prep.tiled_inputs(pm, ligands, threads=8)
    x = [torch.from_numpy(a).to(dev) for a in ti.arrays]
    d = (ti.depth1, ti.depth2)
    print(f"tiles={x[0].shape[0]} d1={ti.depth1} d2={ti.depth2}", flush=True)

    calls = {m: lambda m=m: screen_cuda.score_tiles_fused_variant(*x, *d, m) for m in VARIANTS}
    base = calls["full"]()
    for mode, call in calls.items():
        diff, mism, ok = agreement(call(), base)
        print(f"{mode}: max|diff| vs full={diff:.2e} -1 mismatches={mism}", flush=True)
        if not ok:
            print(f"{mode} disagrees with full: none timed", flush=True)
            return 1
    times = time_rounds(dev, calls)
    for mode, t in times.items():
        print(time_line(mode, t, args.ligands), flush=True)
    print(launch_line("probe_kernel_r3", dev, KERNELS,
                      {f"{KERNELS[0]}[{m}]": t for m, t in times.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
