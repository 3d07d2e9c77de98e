"""The screening batch's block, pair and group structure on bench.py's
pool (20-cluster model seed 0, --n ligands x 4 conformers seed 1): the
data behind the v3 layout (group tables, block-major rows) and what each
mn cap set would stream and compute.

    python -m pharmaconet_tpu_torch.probes.probe_layout_stats [--n 2048] [--device cuda]

Host only: `build_batch` and numpy; --device is checked like every
probe's and nothing runs there. Reports the rows per block, the slot
fill, the mn histogram, blocks and rows per pair, the distinct groups
(model cluster pair x ligand node type masks) and whether a group fixes
mn, groups per family, and for the cap sets [8, 16, 64], [16, 64] and
[64] the rows, tiles, streamed bytes and exp count of a one-row-per-block
layout beside the dt kernel's. The lines are the JAX probe's, word for
word. The counterpart of the JAX `probes/probe_layout_stats.py`.
"""

from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

import numpy as np

from . import stored_route as sr
from .stored_route import log

CAP_SETS = ([8, 16, 64], [16, 64], [64])
TILE = 1024
G_CAP = 32


def build_parser():
    return sr.parser(__doc__.splitlines()[0], 2048, "ligands")


def layout_stats(pm, ligands) -> tuple[dict, list[str]]:
    """(numbers, the JAX probe's lines) of one batch of ligands."""
    from ..scoring.batch_screen import BLOCK_P, build_batch

    batch = build_batch(pm, ligands)
    ns, nb = len(batch.sub_d_idx), len(batch.block_mn)
    npair, total_mn, c = len(batch.pair_threshold), int(batch.block_mn.sum()), batch.cmax
    mn_hist = Counter(batch.block_mn.tolist())
    blocks_per_pair = np.bincount(batch.block_pair, minlength=npair)
    rows_per_pair = np.bincount(batch.block_pair[batch.sub_block], minlength=npair)
    lines = [
        f"ligands={len(ligands)} NS={ns} NB={nb} NP={npair} sum_mn={total_mn} cmax={c}",
        f"rows/block: NS/NB={ns / nb:.2f}",
        f"slot fill: sum_mn/(NS*P)={total_mn / (ns * BLOCK_P):.3f}",
        f"mn histogram (top): {sorted(mn_hist.items())[:20]}",
        f"mn max: {batch.block_mn.max()}  p99: {int(np.percentile(batch.block_mn, 99))}",
        f"blocks/pair: mean={blocks_per_pair.mean():.2f} max={blocks_per_pair.max()} "
        f"p99={int(np.percentile(blocks_per_pair, 99))}",
        f"rows/pair (today): mean={rows_per_pair.mean():.2f} max={rows_per_pair.max()} "
        f"p99={int(np.percentile(rows_per_pair, 99))}",
    ]

    # group = (m1, m2, mask_u, mask_v): fixes the block's (mu, std, w)
    # table, its mn and its fail threshold; read from each block's first row
    ln = batch.ln
    first_row = np.zeros(nb, dtype=np.int64)
    for row in range(ns - 1, -1, -1):
        first_row[batch.sub_block[row]] = row
    d_idx = batch.sub_d_idx[first_row].astype(np.int64)
    li, rem = d_idx // (ln * ln), d_idx % (ln * ln)
    masks = np.zeros((len(ligands), ln), dtype=np.int64)
    for i, lig in enumerate(ligands):
        masks[i, : len(lig.node_mask)] = lig.node_mask
    mask_u, mask_v = masks[li, rem // ln], masks[li, rem % ln]
    meta = batch.pair_meta[batch.block_pair]
    m1, m2, is_self = (meta[:, k].astype(np.int64) for k in (3, 4, 5))
    gkey = (((is_self * 64 + m1) * 64 + m2) * 256 + mask_u) * 256 + mask_v
    uniq_g, g_inv, g_counts = np.unique(gkey, return_inverse=True, return_counts=True)
    g_mn = np.zeros(len(uniq_g), dtype=np.int64)
    g_mn[g_inv] = batch.block_mn
    same = bool(np.all(g_mn[g_inv] == batch.block_mn))
    fam = (is_self * 64 + m1) * 64 + m2
    fam_groups = Counter()
    for f, _ in set(zip(fam.tolist(), gkey.tolist())):
        fam_groups[f] += 1
    fg = np.array(sorted(fam_groups.values()))
    lines += [
        f"distinct groups (model-wide): {len(uniq_g)}",
        f"group determines mn: {same}",
        f"group table bytes (sum mn*3*4): {int(g_mn.sum() * 12)}",
        f"blocks per group: mean={g_counts.mean():.1f} max={g_counts.max()}",
        f"families={len(fam_groups)} groups/family: mean={fg.mean():.1f} max={fg.max()} "
        f"p99={int(np.percentile(fg, 99))}",
    ]

    t_today = -(-ns // TILE)
    stream_today = t_today * (3 * BLOCK_P * 4 + 4 * c + 7 * 4 + 4 * c) * TILE
    lines.append(f"\ntoday (dt kernel): T={t_today} stream~{stream_today / 1e6:.0f} MB "
                 f"exp={ns * BLOCK_P * c / 1e6:.0f}M")
    caps_out = []
    for caps in CAP_SETS:
        rows = expw = 0
        for mn, cnt in mn_hist.items():
            rows += cnt
            expw += cnt * next(x for x in caps if mn <= x)
        t3 = -(-rows // TILE)
        stream3 = t3 * ((4 * c + 4 + 4 * 4) * TILE + G_CAP * (3 * max(caps) + 4) * 4)
        caps_out.append(dict(caps=caps, rows=rows, tiles=t3, stream_bytes=stream3,
                             exp=expw * c))
        lines.append(f"v3a caps={caps}: rows={rows} T={t3} stream~{stream3 / 1e6:.0f} MB "
                     f"exp={expw * c / 1e6:.0f}M")
    numbers = dict(ns=ns, nb=nb, np=npair, sum_mn=total_mn, cmax=c,
                   mn_max=int(batch.block_mn.max()), groups=len(uniq_g),
                   group_determines_mn=same, families=len(fam_groups),
                   dt_kernel=dict(tiles=t_today, stream_bytes=stream_today,
                                  exp=ns * BLOCK_P * c),
                   cap_sets=caps_out)
    return numbers, lines


def body(args, work: Path, report: dict) -> None:
    sr.device_of(args)
    _, pm, ligands, _ = sr.headline_inputs(args.n)
    report["stats"], report["lines"] = layout_stats(pm, ligands)
    for line in report["lines"]:
        log(line)


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_layout_stats", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
