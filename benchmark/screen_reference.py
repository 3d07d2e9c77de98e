"""Plain reference of pharmacophore screening: one ligand's score against
one pocket model, in numpy, from the arrays the benchmark generates.

It imports nothing of the program and reads nothing the program made: the
model comes from its state dict (`ligand_traffic.model_state`), the ligand
from the generated library. The semantics are upstream PharmacoNet's
`GraphMatcher` with its production numba kernels
(src/pmnet/scoring/graph_match.py, tree.py, match_utils_numba.py):

* candidates: the model clusters whose types overlap a ligand cluster's;
  the ligand clusters that have any, in the library's order, at most 20;
* a block is one ligand node pair (u, v) against the model nodes each
  matches in one model cluster pair; per conformer, d = |pos_u - pos_v|,
  x = (d - mu) / std per model node pair, a term w_p w_q / std
  exp(-x^2 / 2), a pass where x^2 < 4; the block's score is the mean of
  its terms, and it fails where fewer than (M N + 1) // 2 pass;
* a cross pair (two ligand clusters against two model clusters) sums its
  blocks and scores -1 where more than half its blocks fail, or at every
  conformer where the geometric prune drops it; a self pair sums the
  blocks of node pairs within one ligand cluster and never fails;
* the assignment tree (tree.py) assigns each ligand cluster a candidate
  or none, keeps a conformer only while every cross pair with an assigned
  ancestor is > 0, takes the none branch where no candidate survives or
  fewer than 5 matches could be completed, and the score is the mean over
  conformers of the best leaf (0 where no leaf is positive).

The f32 steps follow the program's order of operations (d =
sqrt((dx^2 + dy^2) + dz^2), x = (d - mu) * (1 / std)), so that the
discrete decisions (x^2 < 4, the prune, > 0) fall as the program's do;
sums may run in another order. `precision="bfloat16"` rounds every
step of the Gaussian phase to bfloat16, as torch's bfloat16 elementwise
operations do (the benchmark's control).
"""

from __future__ import annotations

import math

import numpy as np

from ligand_traffic import TYPE_INDEX, TYPES

MAX_MATCH_DEPTH = 20
MIN_MATCHES_FOR_SKIP = 5
SIGMA_SQ_PASS = 4.0


class Model:
    """The pocket model's arrays, from its state dict and the screening
    weights (type name -> weight)."""

    def __init__(self, state: dict, weights: dict[str, float]):
        nodes = state["nodes"]
        n = len(nodes)
        self.mu = np.zeros((n, n), np.float32)
        self.std = np.ones((n, n), np.float32)
        for e in state["edges"]:
            i, j = e["node_indices"]
            self.mu[i, j] = self.mu[j, i] = e["distance_mean"]
            self.std[i, j] = self.std[j, i] = e["distance_std"]
        self.weight = np.array([weights[nd["type"]] for nd in nodes], np.float32)
        self.node_type = np.array([TYPE_INDEX[nd["type"]] for nd in nodes], np.int64)
        clusters = [c for cl in state["node_cluster_dict"].values() for c in cl]
        self.cluster_nodes = [sorted(int(i) for i in c["node_indices"]) for c in clusters]
        self.cluster_mask = np.array(
            [sum(1 << TYPE_INDEX[t] for t in set(c["node_types"])) for c in clusters],
            np.int64)
        self.cluster_center = np.array([c["center"] for c in clusters], np.float32)
        self.cluster_size = np.array([c["size"] for c in clusters], np.float32)
        self.inv_std = (np.float32(1.0) / self.std).astype(np.float32)

    def matched(self, umask: int, m: int) -> list[int]:
        """Model nodes of cluster m whose type the ligand node's mask holds,
        in type order, then node order."""
        return [i for t in range(len(TYPES)) if umask >> t & 1
                for i in self.cluster_nodes[m] if self.node_type[i] == t]


def _f32(x):
    return np.asarray(x, np.float32)


def _bf16(x):
    """x rounded to the nearest bfloat16 (ties to even), held in f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


ROUNDING = {"float32": _f32, "bfloat16": _bf16}


def _dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return np.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])


def _node_pair(model: Model, d: np.ndarray, a: list[list[int]], b: list[list[int]], r):
    """The blocks of one ligand node pair against every candidate pair:
    d [C] its distances, a[k1] and b[k2] the model nodes its two ligand
    nodes match in their k-th candidates (empty where they match none).
    Returns (score [K1, K2, C], failed [K1, K2, C], real [K1, K2]); r
    rounds each step to the working precision."""
    la = np.array([len(x) for x in a])
    lb = np.array([len(x) for x in b])
    real = (la[:, None] > 0) & (lb[None, :] > 0)
    c = len(d)
    score = np.zeros((len(a), len(b), c), np.float32)
    failed = np.zeros((len(a), len(b), c), bool)
    if not real.any():
        return score, failed, real
    ka, kb = np.flatnonzero(la), np.flatnonzero(lb)
    ia = np.concatenate([a[k] for k in ka])[:, None]
    ib = np.concatenate([b[k] for k in kb])[None, :]
    mu = r(model.mu[ia, ib])  # [M, N] over every candidate's nodes
    inv = r(model.inv_std[ia, ib])
    w = r(model.weight[ia] * model.weight[ib])
    x = r(r(r(d)[:, None, None] - mu) * inv)  # [C, M, N]
    x2 = r(x * x)
    term = r(r(w * inv) * r(np.exp(r(np.float32(-0.5) * x2))))
    hit = (x2 < np.float32(SIGMA_SQ_PASS)).astype(np.int64)
    sa = np.concatenate([[0], np.cumsum(la[ka])[:-1]])
    sb = np.concatenate([[0], np.cumsum(lb[kb])[:-1]])

    def seg(v):  # sums over each candidate's rows and columns
        return np.add.reduceat(np.add.reduceat(v, sa, axis=1), sb, axis=2)

    mn = (la[ka][:, None] * lb[kb][None, :]).astype(np.float32)  # [Ka, Kb]
    s = r(r(seg(term)) / mn[None])  # [C, Ka, Kb]
    f = seg(hit) < (mn[None].astype(np.int64) + 1) // 2
    score[np.ix_(ka, kb)] = s.transpose(1, 2, 0)
    failed[np.ix_(ka, kb)] = f.transpose(1, 2, 0)
    return score, failed, real


def pair_tables(model: Model, lig: dict, precision: str = "float32"):
    """The ligand's pair scores: (active, cands, self_scores, cross), with
    self_scores[i] [K, C] for active cluster i's K candidates, and
    cross[(i1, i2)] [K1, K2, C] for active i1 < i2 (-1 where failed or
    pruned)."""
    r = ROUNDING[precision]
    pos = lig["node_pos"]
    c = lig["num_conformers"]
    clusters = lig["clusters"]
    cands = [[m for m in range(len(model.cluster_nodes))
              if int(lig["cluster_mask"][l]) & int(model.cluster_mask[m])]
             for l in range(len(clusters))]
    active = [l for l in range(len(clusters)) if cands[l]][:MAX_MATCH_DEPTH]
    masks = [int(x) for x in lig["node_mask"]]
    # per active cluster, per node: the model nodes it matches in each candidate
    matched = [{u: [model.matched(masks[u], m) for m in cands[l]] for u in clusters[l]}
               for l in active]

    self_scores = []
    for i, l in enumerate(active):
        s = np.zeros((len(cands[l]), c), np.float32)
        nodes = clusters[l]
        for j1 in range(len(nodes)):
            for j2 in range(j1 + 1, len(nodes)):
                u, v = nodes[j1], nodes[j2]
                bs, _, real = _node_pair(model, _dist(pos[u], pos[v]),
                                         matched[i][u], matched[i][v], r)
                diag = np.arange(len(cands[l]))
                s = s + np.where(real[diag, diag][:, None], bs[diag, diag], 0.0)
        self_scores.append(s)

    mc = model.cluster_center
    cross = {}
    for i1 in range(len(active)):
        for i2 in range(i1 + 1, len(active)):
            l1, l2 = active[i1], active[i2]
            k1, k2 = np.array(cands[l1]), np.array(cands[l2])
            s = np.zeros((len(k1), len(k2), c), np.float32)
            fails = np.zeros((len(k1), len(k2), c), np.int64)
            n1 = np.zeros(len(k1), np.int64)  # nodes of l1 that match each candidate
            n2 = np.zeros(len(k2), np.int64)
            for u in clusters[l1]:
                n1 += np.array([len(x) > 0 for x in matched[i1][u]])
            for v in clusters[l2]:
                n2 += np.array([len(x) > 0 for x in matched[i2][v]])
            for u in clusters[l1]:
                for v in clusters[l2]:
                    bs, bf, real = _node_pair(model, _dist(pos[u], pos[v]),
                                              matched[i1][u], matched[i2][v], r)
                    s = s + np.where(real[..., None], bs, 0.0)
                    fails += bf & real[..., None]
            tab = np.where(fails > (n1[:, None] * n2[None, :] * 0.5)[..., None], -1.0, s)
            # geometric prune: every conformer's ligand distance too far off
            lig_d = _dist(lig["cluster_center"][l1], lig["cluster_center"][l2])  # [C]
            lig_s = lig["cluster_size"][l1] + lig["cluster_size"][l2]
            model_d = _dist(mc[k1][:, None], mc[k2][None, :])  # [K1, K2]
            model_s = model.cluster_size[k1][:, None] + model.cluster_size[k2][None, :]
            gap = np.min(np.abs(lig_d[None, None] - model_d[..., None]) - lig_s, axis=-1)
            tab[gap > model_s] = -1.0
            cross[(i1, i2)] = tab.astype(np.float32)
    return active, cands, self_scores, cross


def assignment_score(active, cands, self_scores, cross, c: int) -> float:
    """The assignment tree's score from the pair tables (tree.py)."""
    n = len(active)
    if n == 0:
        return 0.0
    counts = [len(cands[l]) for l in active]
    best = np.zeros(c)

    def visit(level, ps, alive, num_matches, state, assigned):
        # state[i] = (accum [K_i, C], alive [K_i, C]) for levels i > level:
        # cross scores summed against the assigned ancestors so far
        if assigned is not None:
            upd = {}
            for i, (acc, alv) in state.items():
                pair = cross[(level, i)][assigned]  # [K_i, C]
                upd[i] = (acc + pair, alv & alive[None, :] & (pair > 0))
            state = upd
        if level == n - 1:
            np.maximum(best, np.where(alive, ps, 0.0), out=best)
            return int(assigned is not None)
        child = level + 1
        acc, alv = state[child]
        rest = {i: s for i, s in state.items() if i != child}
        most = 0
        live = [k for k in range(counts[child]) if alv[k].any()]
        for k in live:
            child_ps = np.where(alv[k], ps + self_scores[child][k] + acc[k], 0.0)
            most = max(visit(child, child_ps, alv[k], num_matches + 1, rest, k), most)
        if not live or num_matches + most < MIN_MATCHES_FOR_SKIP:
            most = max(visit(child, ps, alive, num_matches, rest, None), most)
        return most + int(assigned is not None)

    state = {i: (np.zeros((counts[i], c)), np.ones((counts[i], c), bool))
             for i in range(n)}
    visit(-1, np.zeros(c), np.ones(c, bool), 0, state, None)
    return float(np.mean(best))


def ligand_score(model: Model, lig: dict, precision: str = "float32") -> float:
    """One ligand's screening score."""
    tables = pair_tables(model, lig, precision)
    return assignment_score(*tables, c=lig["num_conformers"])


def tolerance_share(got: float, want: float, rtol: float, atol: float) -> float:
    """|got - want| as a share of the repo's score tolerance (1 = at it)."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / (atol + rtol * abs(want))
