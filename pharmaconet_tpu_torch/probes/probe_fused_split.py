"""Probe P3: where K1's time goes. Each ablation of the fused screening
kernel (`score_tiles_fused_ablation`) is timed at the headline batch:

  full    K1 itself
  noscan  the Gaussian phase only: scores + pass counts written, no scans,
          no fail logic, no aux rows read
  noexp   full with winv·x² in place of winv·exp(-x²/2)
  nohot   full with the constant distance 1.5 + pos[t, 0, 0]: no uv and no
          node table read, no selection
  gauss0  nohot, noexp and noscan together: the tables streamed through
          the Gaussian loop

`full` is first held against K1's own wrapper on the same tiles; the modes
are timed in turn over three rounds (median); the last lines give full -
noscan (scans), full - noexp (expf) and full - nohot (selection) as shares
of full, from the back-to-back times on the card. The counterpart of the
repo's probes/probe_fused_split.py.

    python -m pharmaconet_tpu_torch.probes.probe_fused_split [--device cuda|cpu] [--ligands 2048]
"""

from __future__ import annotations

import sys

import torch

from ..ops import screen_cuda
from ..ops.screen_ref import ABLATIONS
from . import agreement, device_line, launch_line, parse_args, prep, time_line
from .timing import time_rounds

KERNELS = ("score_tiles_fused_ablation",)
SHARES = (("scan", "noscan"), ("expf", "noexp"), ("selection", "nohot"))


def main(argv: list[str] | None = None) -> int:
    args = parse_args(__doc__.splitlines()[0], argv)
    dev = args.device
    print(device_line(dev), flush=True)
    pm, ligands = prep.headline_inputs(args.ligands)
    ti = prep.tiled_inputs(pm, ligands, threads=8)
    x = [torch.from_numpy(a).to(dev) for a in ti.arrays]
    d = (ti.depth1, ti.depth2)
    print(f"tiles={x[0].shape[0]} d1={ti.depth1} d2={ti.depth2}", flush=True)

    k1 = screen_cuda.score_tiles_fused_rows(*x, *d)
    diff, mism, ok = agreement(screen_cuda.score_tiles_fused_ablation(*x, *d, "full"), k1)
    print(f"full vs K1: max|diff|={diff:.2e} -1 mismatches={mism}", flush=True)
    if not ok:
        print("full disagrees with K1 on the same tiles", flush=True)
        return 1
    times = time_rounds(dev, {m: lambda m=m: screen_cuda.score_tiles_fused_ablation(*x, *d, m)
                              for m in ABLATIONS})
    for mode, t in times.items():
        print(time_line(mode, t, args.ligands), flush=True)
    full = times["full"].per_batch
    for stage, mode in SHARES:
        share = full - times[mode].per_batch
        print(f"{stage} share (full - {mode}): {share:.4f} ms, "
              f"{100 * share / full:.1f}% of full", flush=True)
    print(launch_line("probe_fused_split", dev, KERNELS,
                      {f"{KERNELS[0]}[{m}]": t for m, t in times.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
