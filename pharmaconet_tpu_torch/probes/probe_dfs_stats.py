"""The shape of the assignment search: frontier widths of the relaxed
expansion tree, per-ligand level, candidate and slot counts, and the gated
search's leaves, nodes and rows per leaf, over three pools.

    python -m pharmaconet_tpu_torch.probes.probe_dfs_stats [--n 512] [--device cuda]

Pools: bench.py's synthetic ligands (seed 1) against the 20-cluster model
(seed 0); a corpus of --n random molecules written as SDF and read back
(`synthetic._random_molecule`, seed 42) against the same model; the
synthetic ligands against a 40-cluster model (seed 7). Each pool's pair
table comes from the plain-torch reference engine on --device
(`BatchScreener(engine="reference").run_device`), compacted and pruned as
the host tail does; everything after it is host work. The lines are the
JAX probe's, word for word. Gate: the gated search ported here
(`gated_leafs`, a Python mirror of native/match_dfs.cpp) gives the
production DFS's scores (`batch_screen._dfs_scores`) for ligands 0, 1, 7,
100 and 311 (those below --n) within rtol 2e-5 / atol 1e-4. The
counterpart of the JAX `probes/probe_dfs_stats.py`.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

from . import stored_route as sr
from .stored_route import log

CHECKED = (0, 1, 7, 100, 311)
FRONTIERS = (16, 32, 64, 128, 256, 512, 1024, 4096)


def build_parser():
    return sr.parser(__doc__.splitlines()[0], 512, "ligands per pool")


def _offsets(batch, li: int):
    """(pair start, conformers, candidate counts, self-row offsets,
    cross-row offsets) of ligand li's block of pair rows, in the packer's
    emission order."""
    start, _ = batch.pair_slices[li]
    active, cands = batch.candidates[li]
    counts = [len(cands[l]) for l in active]
    self_off, row = [], 0
    for k in counts:
        self_off.append(row)
        row += k
    cross_off = {}
    for i1 in range(len(counts)):
        for i2 in range(i1 + 1, len(counts)):
            cross_off[(i1, i2)] = row
            row += counts[i1] * counts[i2]
    return start, int(batch.num_conformers[li]), counts, self_off, cross_off


def simulate_bfs(batch, table, li: int):
    """The relaxed expansion of ligand li's tree (a None child always
    kept): (frontier width per level, self slots, largest candidate
    count)."""
    start, c, counts, self_off, cross_off = _offsets(batch, li)
    n = len(counts)
    if n == 0 or c == 0:
        return [1], 0, 0

    def cross_row(i1, j1, i2, j2):
        return start + cross_off[(i1, i2)] + j1 * counts[i2] + j2

    frontier = [((), np.ones(c, dtype=bool))]
    widths = [1]
    for lv in range(n):
        new = []
        for assign, alive in frontier:
            for j in range(counts[lv]):
                a2 = alive.copy()
                for k, jk in enumerate(assign):
                    if jk >= 0:
                        a2 &= table[cross_row(k, jk, lv, j), :c] > 0
                if a2.any():
                    new.append((assign + (j,), a2))
            new.append((assign + (-1,), alive))
        frontier = new
        widths.append(len(frontier))
    return widths, sum(counts), max(counts)


def gated_leafs(batch, table, li: int):
    """The gated search of ligand li (native/match_dfs.cpp in Python):
    (leaves, nodes, rows per leaf, score)."""
    start, c, counts, self_off, cross_off = _offsets(batch, li)
    n = len(counts)
    if n == 0 or c == 0:
        return 0, 0, [], 0.0

    def srow(lv, j):
        return start + self_off[lv] + j

    def xrow(i1, j1, i2, j2):
        return start + cross_off[(i1, i2)] + j1 * counts[i2] + j2

    stats = {"leaves": 0, "nodes": 0, "rows": []}
    best = np.zeros(c, dtype=np.float64)

    def rec(level, assign, ps, alive, num_matches):
        stats["nodes"] += 1
        if level == n:
            stats["leaves"] += 1
            k = sum(1 for a in assign if a >= 0)
            stats["rows"].append(k + k * (k - 1) // 2)
            np.maximum(best, np.where(alive, ps, 0.0), out=best)
            return 0
        max_matches, any_child = 0, False
        for j in range(counts[level]):
            a2 = alive.copy()
            for k in range(level):
                if assign[k] >= 0:
                    a2 &= table[xrow(k, assign[k], level, j), :c] > 0
            if not a2.any():
                continue
            any_child = True
            ps2 = ps + table[srow(level, j), :c].astype(np.float64)
            for k in range(level):
                if assign[k] >= 0:
                    ps2 = ps2 + table[xrow(k, assign[k], level, j), :c]
            max_matches = max(max_matches, rec(level + 1, assign + [j], ps2, a2,
                                               num_matches + 1) + 1)
        if not any_child or num_matches + max_matches < 5:
            max_matches = max(max_matches, rec(level + 1, assign + [-1], ps, alive, num_matches))
        return max_matches

    rec(0, [], np.zeros(c, dtype=np.float64), np.ones(c, dtype=bool), 0)
    return stats["leaves"], stats["nodes"], stats["rows"], float(best.mean())


def collect(batch, table, tag: str) -> tuple[dict, list[str]]:
    """The relaxed tree's statistics over a pool: (numbers, the JAX
    probe's lines)."""
    n_lig = len(batch.ligand_clusters)
    maxw, n_active, smax, kmax = [], [], [], []
    for li in range(n_lig):
        widths, slots, k = simulate_bfs(batch, table, li)
        maxw.append(max(widths))
        n_active.append(len(batch.candidates[li][0]))
        smax.append(slots)
        kmax.append(k)
    maxw = np.array(maxw)
    cover = {w: float((maxw <= w).mean()) for w in FRONTIERS}
    lines = [
        f"[{tag}] ligands={n_lig}",
        f"  n_active: max={max(n_active)} p99={np.percentile(n_active, 99):.0f} "
        f"mean={np.mean(n_active):.1f}",
        f"  slots(S): max={max(smax)} p99={np.percentile(smax, 99):.0f} mean={np.mean(smax):.1f}",
        f"  cand(K):  max={max(kmax)}",
        *(f"  frontier<={w:5d}: {cover[w] * 100:6.2f}%" for w in FRONTIERS),
        f"  frontier max={maxw.max()} p99={np.percentile(maxw, 99):.0f} "
        f"p90={np.percentile(maxw, 90):.0f} mean={maxw.mean():.0f}",
    ]
    numbers = dict(ligands=n_lig, n_active_max=max(n_active), slots_max=max(smax),
                   cand_max=max(kmax), frontier_max=int(maxw.max()),
                   frontier_cover={str(w): v for w, v in cover.items()})
    return numbers, lines


def collect_gated(batch, table, tag: str) -> tuple[dict, list[str]]:
    """The gated search's statistics over a pool: (numbers, the JAX
    probe's lines)."""
    n_lig = len(batch.ligand_clusters)
    leaves, nodes, rows = [], [], []
    for li in range(n_lig):
        lf, nd, rw, _ = gated_leafs(batch, table, li)
        leaves.append(lf)
        nodes.append(nd)
        rows.extend(rw)
    leaves = np.array(leaves)
    rows = np.array(rows) if rows else np.zeros(1)
    lines = [
        f"[GATED {tag}] ligands={n_lig}",
        f"  leaves: max={leaves.max()} p99={np.percentile(leaves, 99):.0f} "
        f"p90={np.percentile(leaves, 90):.0f} mean={leaves.mean():.1f} total={leaves.sum()}",
        f"  nodes:  mean={np.mean(nodes):.0f} max={max(nodes)}",
        f"  rows/leaf: max={rows.max():.0f} p99={np.percentile(rows, 99):.0f} "
        f"mean={rows.mean():.1f}",
    ]
    numbers = dict(leaves_max=int(leaves.max()), leaves_total=int(leaves.sum()),
                   nodes_max=int(max(nodes)), rows_per_leaf_max=float(rows.max()))
    return numbers, lines


def table_for(pm, packed, dev):
    """(batch, pair table): the reference engine's expanded table on dev,
    compacted, the geometric prune applied."""
    from ..scoring.batch_screen import (
        BatchScreener,
        build_batch,
        compact_pair_table,
        host_prune_mask,
    )

    screener = BatchScreener(pm, engine="reference", device=dev)
    batch = build_batch(pm, packed)
    table = compact_pair_table(batch, screener._to_host(screener.run_device(batch)))
    prune = host_prune_mask(batch, pm)
    table[: len(prune)][prune] = -1.0
    return batch, table


def sdf_pool(n: int, seed: int = 42) -> list:
    """n random molecules written as SDF and read back, those with
    clusters packed."""
    from ..scoring.batch_screen import PackedLigand
    from ..scoring.ligand import Ligand
    from ..synthetic import _random_molecule, _to_sdf

    rng = np.random.default_rng(seed)
    packed = []
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            path = Path(td) / f"l{i}.sdf"
            path.write_text(_to_sdf(f"l{i}", *_random_molecule(rng)))
            pk = PackedLigand.from_ligand(Ligand.load_from_file(path))
            if pk.clusters:
                packed.append(pk)
    return packed


def pool_stats(batch, table, tag: str) -> tuple[dict, list[str]]:
    relaxed, lines = collect(batch, table, tag)
    gated, more = collect_gated(batch, table, tag)
    return dict(relaxed=relaxed, gated=gated), lines + more


def body(args, work: Path, report: dict) -> None:
    from ..scoring.batch_screen import PackedModel, _dfs_scores
    from ..synthetic import make_synthetic_model

    dev = sr.device_of(args)
    _, pm, packed, _ = sr.headline_inputs(args.n)
    batch, table = table_for(pm, packed, dev)
    pools = {}
    pools["synthetic"] = pool_stats(batch, table, "bench synthetic pool (20-cluster model)")

    production = _dfs_scores(batch, table)
    checked = [li for li in CHECKED if li < len(production)]
    gated = [gated_leafs(batch, table, li)[3] for li in checked]
    report["score_gate"] = dict(ligands=checked, **sr.gate_scores(
        "gated search against the production DFS", gated, [production[li] for li in checked]))
    pools["synthetic"][1].append("  gated port score check vs production DFS: ok")

    batch2, table2 = table_for(pm, sdf_pool(args.n), dev)
    pools["sdf"] = pool_stats(batch2, table2, "sdf corpus (20-cluster model)")
    big = PackedModel.from_model(make_synthetic_model(num_clusters=40, seed=7))
    batch3, table3 = table_for(big, packed, dev)
    pools["clusters40"] = pool_stats(batch3, table3, "bench synthetic pool (40-cluster model)")
    report["pools"] = {k: v[0] for k, v in pools.items()}
    report["lines"] = [line for _, lines in pools.values() for line in lines]
    for line in report["lines"]:
        log(line)


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_dfs_stats", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
