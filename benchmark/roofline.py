"""The chip's published peaks, and the work a screen needs, counted from
the generated model and ligands (never from the program's layout).

`f32_ops` is chip_smoke.py's operation count, copied. `screening_work`
counts what upstream PharmacoNet's matcher computes for a library: for
every cross pair of active ligand clusters against every candidate model
cluster pair that the geometric prune keeps, and every self pair, one
Gaussian entry per (ligand node pair, matched model node pair) per
conformer, and one distance per conformer for each ligand node pair those
entries use. Bytes: the ligand coordinates and type masks read once, one
f32 score written per ligand. So the roofline reads the same work whatever
the program does to compute it.
"""

from __future__ import annotations

import numpy as np

from ligand_traffic import TYPES, Ligands
from screen_reference import MAX_MATCH_DEPTH, Model

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, published HBM3 rate
F32_OPS_PER_S = 67e12  # NVIDIA H100 SXM, published f32 rate outside the tensor cores


def f32_ops(c: int, rows: int, entries: int, distance: bool, depths: tuple,
            per_entry: int = 9) -> int:
    """f32 operations the kernels must do (exp and sqrt as one): the
    distance, 9 per conformer of each row where it is rebuilt; 9 per
    (valid Gaussian entry, conformer), 7 without the exp and its -1/2; and
    where there are scans, one add per scan step and stacked value plus 3
    per conformer in the tails. `entries` counts this run's Gaussian
    entries with weight > 0."""
    ops = per_entry * c * entries + (9 * c * rows if distance else 0)
    if depths:
        ops += rows * (2 * c * sum(depths) + 3 * c)
    return ops


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip needs for the work, and what bounds it."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "f32") if t_ops >= t_bytes else (t_bytes, "hbm")


def _dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])


def type_counts(model: Model) -> np.ndarray:
    """[7, M]: nodes of each type in each model cluster."""
    out = np.zeros((len(TYPES), len(model.cluster_nodes)), np.int64)
    for m, nodes in enumerate(model.cluster_nodes):
        for i in nodes:
            out[model.node_type[i], m] += 1
    return out


def ligand_work(model: Model, lig: dict, counts: np.ndarray) -> tuple[int, int]:
    """(Gaussian entries, distance rows) of one ligand, per conformer;
    `counts` is type_counts(model). The plain statement of what
    screening_work counts for a whole library at once."""
    bits = (lig["node_mask"][:, None].astype(np.int64)
            >> np.arange(len(TYPES))[None, :]) & 1  # [Ln, 7]
    matched = bits @ counts  # [Ln, M]: model nodes each ligand node matches
    clusters = lig["clusters"]
    cands = [np.flatnonzero(int(lig["cluster_mask"][l]) & model.cluster_mask)
             for l in range(len(clusters))]
    active = [l for l in range(len(clusters)) if len(cands[l])][:MAX_MATCH_DEPTH]
    entries = 0
    pairs: set[tuple[int, int]] = set()
    for l in active:
        k = cands[l]
        nodes = clusters[l]
        for j1 in range(len(nodes)):
            for j2 in range(j1 + 1, len(nodes)):
                e = int((matched[nodes[j1], k] * matched[nodes[j2], k]).sum())
                if e:
                    entries += e
                    pairs.add((nodes[j1], nodes[j2]))
    mc = model.cluster_center
    for i1 in range(len(active)):
        for i2 in range(i1 + 1, len(active)):
            l1, l2 = active[i1], active[i2]
            k1, k2 = cands[l1], cands[l2]
            lig_d = _dist(lig["cluster_center"][l1], lig["cluster_center"][l2])
            lig_s = lig["cluster_size"][l1] + lig["cluster_size"][l2]
            model_d = _dist(mc[k1][:, None], mc[k2][None, :])
            model_s = model.cluster_size[k1][:, None] + model.cluster_size[k2][None, :]
            gap = np.min(np.abs(lig_d[None, None] - model_d[..., None]) - lig_s, axis=-1)
            kept = ~(gap > model_s)  # [K1, K2]
            for u in clusters[l1]:
                for v in clusters[l2]:
                    e = int((matched[u, k1][:, None] * matched[v, k2][None, :] * kept).sum())
                    if e:
                        entries += e
                        pairs.add((u, v))
    return entries, len(pairs)


def screening_work(model: Model, library: Ligands, chunk: int = 16384) -> tuple[int, int]:
    """(f32 operations, bytes) that screening the whole library needs:
    ligand_work summed over the library, computed for all ligands at once
    (cross pairs in chunks of `chunk`)."""
    lib = library
    c = lib.num_conformers
    counts = type_counts(model)
    n = len(lib)
    ncl = len(lib.cluster_mask)
    cl_lig = np.repeat(np.arange(n), np.diff(lib.cluster_start))
    cand = (lib.cluster_mask[:, None].astype(np.int64) & model.cluster_mask[None, :]) != 0
    # active clusters: those with a candidate, the first MAX_MATCH_DEPTH per ligand
    has = cand.any(axis=1)
    rank = np.cumsum(has) - 1
    rank -= np.repeat(np.concatenate([[0], np.cumsum(has)])[lib.cluster_start[:-1]],
                      np.diff(lib.cluster_start))
    active = has & (rank < MAX_MATCH_DEPTH)

    # node slots of each cluster: [ncl, S] node ids (-1 = none)
    node_cl = lib.node_cluster.astype(np.int64) + lib.cluster_start[
        np.repeat(np.arange(n), np.diff(lib.node_start))]
    order = np.argsort(node_cl, kind="stable")
    per = np.bincount(node_cl, minlength=ncl)
    slots = int(per.max(initial=1))
    first = np.concatenate([[0], np.cumsum(per)[:-1]])
    slot_nodes = np.full((ncl, slots), -1, np.int64)
    pos_in = np.arange(len(node_cl)) - first[node_cl[order]]
    slot_nodes[node_cl[order], pos_in] = order
    bits = (lib.node_mask[:, None].astype(np.int64) >> np.arange(len(TYPES))[None, :]) & 1
    matched = np.concatenate([bits @ counts, np.zeros((1, counts.shape[1]), np.int64)])
    # [ncl, S, M] model nodes each slot's node matches in each candidate
    mslot = matched[slot_nodes] * cand[:, None, :]

    entries = rows = 0
    for a in range(slots):  # self pairs: node slots a < b of one active cluster
        for b in range(a + 1, slots):
            e = (mslot[:, a] * mslot[:, b]).sum(axis=1) * active
            entries += int(e.sum())
            rows += int((e > 0).sum())

    # cross pairs: active clusters k1 < k2 of one ligand
    act = np.flatnonzero(active)
    lig_of = cl_lig[act]
    starts = np.searchsorted(lig_of, np.arange(n))
    ends = np.searchsorted(lig_of, np.arange(n), side="right")
    cnt = ends - starts
    p1, p2 = [], []
    for k in np.unique(cnt):
        ligs = np.flatnonzero(cnt == k)
        a, b = np.triu_indices(int(k), 1)
        p1.append((starts[ligs][:, None] + a[None]).ravel())
        p2.append((starts[ligs][:, None] + b[None]).ravel())
    p1 = act[np.concatenate(p1)] if p1 else np.zeros(0, np.int64)
    p2 = act[np.concatenate(p2)] if p2 else np.zeros(0, np.int64)

    # padded candidate lists per cluster
    kmax = int(cand.sum(axis=1).max(initial=1))
    cidx = np.full((ncl, kmax), -1, np.int64)
    r, m = np.nonzero(cand)
    pos_k = np.arange(len(r)) - np.concatenate([[0], np.cumsum(cand.sum(axis=1))[:-1]])[r]
    cidx[r, pos_k] = m
    mc = np.concatenate([model.cluster_center, np.zeros((1, 3), np.float32)])
    ms = np.concatenate([model.cluster_size, np.zeros(1, np.float32)])
    for s0 in range(0, len(p1), chunk):
        k1, k2 = p1[s0:s0 + chunk], p2[s0:s0 + chunk]
        lig_d = _dist(lib.cluster_center[k1], lib.cluster_center[k2])  # [P, C]
        lig_s = lib.cluster_size[k1] + lib.cluster_size[k2]
        m1, m2 = cidx[k1], cidx[k2]  # [P, K]
        model_d = _dist(mc[m1][:, :, None], mc[m2][:, None, :])  # [P, K, K]
        model_s = ms[m1][:, :, None] + ms[m2][:, None, :]
        gap = np.min(np.abs(lig_d[:, None, None, :] - model_d[..., None])
                     - lig_s[:, None, None, :], axis=-1)
        kept = ~(gap > model_s) & (m1[:, :, None] >= 0) & (m2[:, None, :] >= 0)
        g1 = np.take_along_axis(mslot[k1], np.maximum(m1, 0)[:, None, :], axis=2)  # [P, S, K]
        g2 = np.take_along_axis(mslot[k2], np.maximum(m2, 0)[:, None, :], axis=2)
        for a in range(slots):
            for b in range(slots):
                e = np.einsum("pk,pkl,pl->p", g1[:, a], kept.astype(np.int64), g2[:, b])
                entries += int(e.sum())
                rows += int((e > 0).sum())
    ops = f32_ops(c, rows, entries, distance=True, depths=())
    nbytes = (lib.node_pos.nbytes + lib.node_mask.nbytes
              + lib.cluster_mask.nbytes + 4 * n)
    return ops, nbytes
