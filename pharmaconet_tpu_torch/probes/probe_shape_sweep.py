"""The stored route over model sizes: model clusters x conformers per
ligand, each a v3 store of --n ligands (bench.py's synthetic model seed 0
at that many clusters, ligands seed 1 at that many conformers) with the
leaves baked on the device, screened on the device.

    python -m pharmaconet_tpu_torch.probes.probe_shape_sweep [--n 2048] \\
        [--clusters 4,10,20,40] [--conformers 4,8] [--layout buckets|single] \\
        [--device cuda]

For each configuration: the stored batch's shape (tiles; the leaf
buckets' (Bk, Lk, Wk) or the single window's caps; gathered window slots;
outlier ligands), K2's group table (g_cap, r_pad) and shared bytes per
block; the device chain (K2 + the leaf chain, operands resident) per
batch back to back and the device's ligands/s; and the host stages
(`stored_route.stored_stages`: store load, the copy to the device, the
chain and the host tail with the outliers' DFS, host clock, median of 3).

Gates, every configuration: K2's rows equal its plain version (rtol 2e-5 /
atol 1e-4, equal -1 masks), and the batch's scores equal the plain-torch
reference engine's (`BatchScreener(engine="reference")` on the same
device, as chip_smoke's phase 6 holds the route) within the same
tolerance. The counterpart of the JAX `probes/probe_shape_sweep.py`
(whose `PROBE_LEAF_LAYOUT` is --layout here).
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import stored_route as sr
from .stored_route import log


def int_list(text: str) -> list[int]:
    return [int(v) for v in text.split(",") if v]


def build_parser():
    p = sr.parser(__doc__.splitlines()[0], 2048, "ligands per configuration (one batch)")
    p.add_argument("--clusters", type=int_list, default=[4, 10, 20, 40])
    p.add_argument("--conformers", type=int_list, default=[4, 8])
    p.add_argument("--layout", default="buckets", choices=("buckets", "single"))
    return p


def sweep_one(args, work: Path, clusters: int, conformers: int, dev) -> dict:
    from ..ops import screen_ref
    from ..scoring.batch_screen import BatchScreener

    model, pm, ligands, names = sr.headline_inputs(args.n, clusters, conformers)
    store = sr.write_store(work / f"tiles_{clusters}_{conformers}", pm, ligands, names, dev,
                           args.n, args.layout)
    sb = store.load(0)
    row = dict(clusters=clusters, conformers=conformers, **sr.store_stats(sb))
    screener = BatchScreener(pm, device=dev)
    ops = sr.operands(screener, sb)
    row["k2_gate"] = sr.gate_rows(f"{clusters}x{conformers}: K2 against its plain version",
                                  ops.rows(), screen_ref.score_tiles_v3_rows(
                                      *ops.k2, ops.depth, ops.mn_cap))
    scores = sr.batch_scores(screener, sb, ops.chain())
    row["gate"] = sr.gate_scores(f"{clusters}x{conformers}: scores against the reference "
                                 "engine", scores, sr.reference_scores(pm, ligands, dev))
    t = sr.times_of(dev, {"chain": ops.chain}, args.reps)["chain"]
    row.update(chain=t, chain_ms=t["per_batch_ms"],
               chain_ligands_per_s=args.n / t["per_batch_ms"] * 1e3,
               host_stages_ms=sr.stored_stages(screener, store, 0))
    return row


def body(args, work: Path, report: dict) -> None:
    dev = sr.device_of(args)
    sr.pin_full_f32()
    report.update(layout=args.layout, rows=[])
    log("| clusters | conf | T | layout (Bk,Lk,Wk) | slots | outliers | g_cap | r_pad | "
        "smem B | chain ms/b | chain lig/s | load / copy / chain / tail ms |")
    for clusters in args.clusters:
        for conformers in args.conformers:
            row = sweep_one(args, work, clusters, conformers, dev)
            report["rows"].append(row)
            h = row["host_stages_ms"]
            log(f"| {clusters} | {conformers} | {row['tiles']} | {row['layout']} "
                f"{' '.join('x'.join(map(str, b)) for b in row['buckets'])} | {row['slots']} | "
                f"{row['outliers']} | {row['g_cap']} | {row['r_pad']} | {row['shared_bytes']} | "
                f"{row['chain_ms']:.4f} | {row['chain_ligands_per_s']:,.0f} | "
                f"{h['load']:.2f} / {h['copy']:.2f} / {h['chain']:.2f} / {h['tail']:.2f} |")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_shape_sweep", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
