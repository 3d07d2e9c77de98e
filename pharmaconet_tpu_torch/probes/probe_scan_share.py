"""How much of K3 (`score_tiles_fused_dt`, the v2 stores' kernel) are its
two bounded scans? K3 on the headline batch's v2 arrays (bench.py's
20-cluster model seed 0, --n ligands x 4 conformers seed 1: the tiles
that hold rows and their prepack-time distances, as chip_smoke's phase 3
sends them) at the batch's (depth1, depth2), at depth2 = 0, at depth1 = 0
and at both 0.

    python -m pharmaconet_tpu_torch.probes.probe_scan_share [--n 2048] [--device cuda]

A scan at depth 0 does nothing, so those tables are not the batch's
scores; the kernel still holds to its plain version at every setting
(rtol 2e-5 / atol 1e-4, equal -1 masks), which is the gate. The four are
timed back to back (`stream_ms`) in turns; the deltas bound what any
rework of the scans can win. The counterpart of the JAX
`probes/probe_scan_share.py` (P3 `noscan` asks the same of K1).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from . import stored_route as sr
from .stored_route import log


def build_parser():
    return sr.parser(__doc__.splitlines()[0], 2048, "ligands (one batch)")


def k3_inputs(pm, ligands, dev: torch.device) -> tuple[list[torch.Tensor], int, int]:
    """([dt, gtab, aux] on dev, depth1, depth2) of the batch's v2 layout:
    the tiles that hold rows and their distances."""
    from ..scoring.screen_tiles import tile_distances
    from ..scoring.tiled_pack import build_tiled_batch

    tb = build_tiled_batch(pm, ligands, threads=8)
    used = -(-tb.nst // 1024)
    arrays = (tile_distances(tb.pos_blocks[:used], tb.uv[:used]), tb.gtab[:used], tb.aux[:used])
    return [torch.from_numpy(a).to(dev) for a in arrays], tb.depth1, tb.depth2


def body(args, work: Path, report: dict) -> None:
    from ..ops import screen_cuda, screen_ref

    dev = sr.device_of(args)
    _, pm, ligands, _ = sr.headline_inputs(args.n)
    k3_in, d1, d2 = k3_inputs(pm, ligands, dev)
    settings = {"full": (d1, d2), "depth2_0": (d1, 0), "depth1_0": (0, d2), "both_0": (0, 0)}
    report.update(tiles=k3_in[0].shape[0], depth1=d1, depth2=d2, gates={})
    log(f"K3 on {k3_in[0].shape[0]} tiles, depth1 {d1}, depth2 {d2}")
    fns = {}
    for name, (a, b) in settings.items():
        fns[name] = lambda a=a, b=b: screen_cuda.score_tiles_fused_dt_rows(*k3_in, a, b)
        report["gates"][name] = sr.gate_rows(
            f"K3 at depths ({a}, {b}) against its plain version", fns[name](),
            screen_ref.score_tiles_fused_dt_rows(*k3_in, a, b))
        log(f"depths ({a}, {b}): K3 equals its plain version {report['gates'][name]}")
    times = sr.times_of(dev, fns, args.reps)
    full = times["full"]["per_batch_ms"]
    share = {k: full - t["per_batch_ms"] for k, t in times.items() if k != "full"}
    report.update(times=times, scan_ms=dict(pair_scan=share["depth2_0"],
                                            sub_scan=share["depth1_0"], both=share["both_0"]),
                  both_share=share["both_0"] / full)
    for k, t in times.items():
        log(f"{k}: {t['per_batch_ms']:.4f} ms per batch")
    log(f"scans: sub {share['depth1_0']:.4f} ms, pair {share['depth2_0']:.4f} ms, both "
        f"{share['both_0']:.4f} ms ({share['both_0'] / full:.1%} of {full:.4f})")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_scan_share", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
