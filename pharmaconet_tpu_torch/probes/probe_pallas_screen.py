"""Probe P1 and P2: two ways to feed the screening Gaussian phase its
distances, each followed by the torch scans of the split route:

  A. the reference engine (`score_blocks_device`, plain torch), baseline
  B. P1 `gaussian_phase_gather`: each row's distances gathered from the
     unique-distance table d_table [NU, C] by slot
  C. P2 `gaussian_phase_local`: per-tile node tables over the untiled rows,
     distances rebuilt from two local index rows

B and C are checked against A (max |diff| < 1e-3 after the scans) before
they are timed, every line in turn over three rounds (median); the last
lines time the Gaussian phases alone and the scans alone. The counterpart
of the repo's probes/probe_pallas_screen.py.

    python -m pharmaconet_tpu_torch.probes.probe_pallas_screen [--device cuda|cpu] [--ligands 2048]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import screen_cuda
from ..scoring.batch_screen import scan_fail, score_blocks_device
from . import device_line, launch_line, parse_args, prep, time_line
from .timing import time_rounds

KERNELS = ("gaussian_phase_gather", "gaussian_phase_local")
MAX_DIFF = 1e-3


def main(argv: list[str] | None = None) -> int:
    args = parse_args(__doc__.splitlines()[0], argv)
    dev = args.device
    print(device_line(dev), flush=True)
    pm, ligands = prep.headline_inputs(args.ligands)
    rb = prep.row_batch(pm, ligands)
    d1, d2 = rb.depth1, rb.depth2
    print(f"ns_real={rb.ns_real} ns_pad={rb.ns} ns_t={rb.ns_t} d1={d1} d2={d2}", flush=True)
    gi = prep.gather_inputs(rb)
    nu, c = gi.d_table.shape
    print(f"NU={nu} ({nu * c * 4 / 1e6:.1f} MB d_table)", flush=True)
    t0 = time.perf_counter()
    lt = prep.local_tables(rb)
    print(f"tiles={rb.ns_t // 1024} max_union={lt.max_union} overflow={lt.overflow} "
          f"tile-prep={time.perf_counter() - t0:.2f}s", flush=True)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    a_args = [to(a) for a in rb.args]
    scan_rows = a_args[7:]
    tables = [to(rb.muT), to(rb.invT), to(rb.winvT)]
    b_in = [to(gi.d_table), to(gi.slots), *tables]
    uv = to(lt.uv_loc)
    c_in = [to(lt.pos_blocks), uv[0], uv[1], *tables]

    def engine_a():
        return score_blocks_device(*a_args, depth1=d1, depth2=d2)

    def scan_phase(sp):
        return scan_fail(sp[:c, : rb.ns], sp[c:, : rb.ns], *scan_rows, d1, d2)

    def gather():
        return screen_cuda.gaussian_phase_gather(*b_in)

    def local():
        return screen_cuda.gaussian_phase_local(*c_in)

    ref = engine_a()
    ok = True
    for label, fn in (("B (P1 gather)", gather), ("C (P2 local)", local)):
        diff = float((scan_phase(fn()) - ref).abs().max())
        print(f"variant {label}: max diff vs A = {diff:.2e}", flush=True)
        ok = ok and diff < MAX_DIFF
    if not ok:
        print(f"a variant differs from A by {MAX_DIFF} or more: not timed", flush=True)
        return 1

    sp_c = local()
    lines = {
        "A reference-full": engine_a,
        "B gather full": lambda: scan_phase(gather()),
        "C local full": lambda: scan_phase(local()),
        "B gather gauss-only": gather,
        "C local gauss-only": local,
        "scan phase only": lambda: scan_phase(sp_c),
    }
    times = time_rounds(dev, lines)
    for label, t in times.items():
        print(time_line(label, t, args.ligands), flush=True)
    kernel_times = {"gaussian_phase_gather": times["B gather gauss-only"],
                    "gaussian_phase_local": times["C local gauss-only"]}
    print(launch_line("probe_pallas_screen", dev, KERNELS, kernel_times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
