"""Batched screening: device-evaluated pair-score tables + host DFS.

The upstream PharmacoNet scores one ligand at a time in numba loops inside a
fork pool. Here screening runs in three stages:

  1. HOST PACK (numpy + native C++) — each ligand graph is flattened into
     "blocks": one block per (ligand-node u, ligand-node v, model-cluster
     pair (a, b)) with its matched model-node pairs padded to BLOCK_P.
     Raggedness lives in ONE flat row axis, and the math stays EXACT (no
     distance tables or interpolation).
  2. DEVICE SCORE (torch) — one pass per batch evaluates every block:
     conformer distances -> Gaussian likelihood terms -> two bounded
     segmented scans (sub-block -> block for pass counting; block ->
     cluster pair for scores/fails). Semantics equal the numba kernels:
     pass iff ((d-mu)/std)^2 < 4, block passes iff num_pass >= (M*N+1)//2,
     pair fails iff fails > n1*n2/2. The default engine ("tiled") and the
     "v3" engine run the hand-written CUDA kernels of ops/screen_cuda.py on
     the card and their plain torch twins (ops/screen_ref.py) on the CPU;
     the "reference" engine is score_blocks_device below, in plain torch.
     Tile-store batches (scoring/tiled_store.py) go through
     BatchScreener.score_stored.
  3. HOST DFS — the assignment tree (native/match_dfs.cpp) consumes the
     per-pair tables.

Scores match GraphMatcher.run() within rtol 2e-5 / atol 1e-4 (tests
enforce it).
"""

from __future__ import annotations

import contextlib
import functools
import types
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import DEFAULT_WEIGHTS, MAX_MATCH_DEPTH
from ..device import resolve_device
from ..ops import screen_cuda
from ..utils import profiling
from . import staging
from .graph_match import priority_fn
from .ligand import Ligand
from .tree import ClusterMatchTreeRoot

BLOCK_P = 8  # model-node pairs per sub-block (larger blocks are split)

PHARMACOPHORE_TYPES = (
    "Hydrophobic",
    "Aromatic",
    "Cation",
    "Anion",
    "HBond_donor",
    "HBond_acceptor",
    "Halogen",
)
TYPE_INDEX = {t: i for i, t in enumerate(PHARMACOPHORE_TYPES)}


def _type_mask(types) -> int:
    mask = 0
    for t in types:
        mask |= 1 << TYPE_INDEX[t]
    return mask


# ==========================================================================
# Model-side packing (once per pocket)
# ==========================================================================
@dataclass
class PackedModel:
    mu: np.ndarray  # [Mn, Mn] edge distance means
    std: np.ndarray  # [Mn, Mn] edge distance stds
    weight: np.ndarray  # [Mn] per-node score weights
    node_type: np.ndarray  # [Mn] type ids
    cluster_nodes: list[list[int]]  # per cluster: node indices
    cluster_mask: np.ndarray  # [M] type bitmask
    cluster_center: np.ndarray  # [M, 3]
    cluster_size: np.ndarray  # [M]
    # per (cluster, type): matched node indices (precomputed candidate sets)
    cluster_type_nodes: list[list[list[int]]]

    def ct_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Flattened (cluster, type) -> node-id tables for the native packer."""
        if not hasattr(self, "_ct_tables"):
            offsets = [0]
            nodes: list[int] = []
            for per_cluster in self.cluster_type_nodes:
                for per_type in per_cluster:
                    nodes.extend(per_type)
                    offsets.append(len(nodes))
            self._ct_tables = (
                np.asarray(offsets, dtype=np.int32),
                np.asarray(nodes, dtype=np.int32),
            )
        return self._ct_tables

    @classmethod
    def from_model(cls, model, weights: dict[str, float] | None = None) -> "PackedModel":
        w = dict(DEFAULT_WEIGHTS)
        if weights:
            w.update(weights)
        nodes = model.nodes
        n = len(nodes)
        mu = np.zeros((n, n), dtype=np.float32)
        std = np.ones((n, n), dtype=np.float32)
        for node in nodes:
            for other, edge in node.neighbor_edge_dict.items():
                mu[node.index, other.index] = edge.distance_mean
                std[node.index, other.index] = edge.distance_std
        weight = np.array([w[node.type] for node in nodes], dtype=np.float32)
        node_type = np.array([TYPE_INDEX[node.type] for node in nodes], dtype=np.int32)

        clusters = model.node_clusters
        cluster_nodes = [sorted(c.node_indices) for c in clusters]
        cluster_mask = np.array(
            [_type_mask(c.node_types) for c in clusters], dtype=np.int32
        )
        cluster_center = np.array([c.center for c in clusters], dtype=np.float32)
        cluster_size = np.array([c.size for c in clusters], dtype=np.float32)
        cluster_type_nodes = [
            [
                [i for i in cluster_nodes[m] if node_type[i] == t]
                for t in range(len(PHARMACOPHORE_TYPES))
            ]
            for m in range(len(clusters))
        ]
        return cls(
            mu, std, weight, node_type, cluster_nodes, cluster_mask,
            cluster_center, cluster_size, cluster_type_nodes,
        )

    @classmethod
    def from_arrays(cls, fields: dict) -> "PackedModel":
        """Rebuild from the fields of a packed model (arrays and the nested
        node-index lists), e.g. `vars()` of `pharmaconet_tpu`'s PackedModel:
        the scoring weights are baked into `weight`, so both packages score
        from the same state."""
        return cls(
            mu=np.asarray(fields["mu"], np.float32),
            std=np.asarray(fields["std"], np.float32),
            weight=np.asarray(fields["weight"], np.float32),
            node_type=np.asarray(fields["node_type"], np.int32),
            cluster_nodes=[[int(i) for i in c] for c in fields["cluster_nodes"]],
            cluster_mask=np.asarray(fields["cluster_mask"], np.int32),
            cluster_center=np.asarray(fields["cluster_center"], np.float32),
            cluster_size=np.asarray(fields["cluster_size"], np.float32),
            cluster_type_nodes=[
                [[int(i) for i in t] for t in c]
                for c in fields["cluster_type_nodes"]
            ],
        )


# ==========================================================================
# Ligand-side packing (once per ligand, model-independent)
# ==========================================================================
@dataclass
class PackedLigand:
    node_pos: np.ndarray  # [Ln, C, 3] node positions per conformer
    node_mask: np.ndarray  # [Ln] int type bitmask per node
    clusters: list[list[int]]  # priority-ordered cluster -> node indices
    cluster_mask: np.ndarray  # [L] type bitmask
    cluster_center: np.ndarray  # [L, C, 3]
    cluster_size: np.ndarray  # [L, C]
    num_conformers: int

    def flat_clusters(self) -> tuple[np.ndarray, np.ndarray]:
        """(members [sum_n], offsets [L+1]) — cached flattening of `clusters`
        for the native packer (avoids per-ligand Python extends per batch)."""
        cached = getattr(self, "_flat_clusters", None)
        if cached is None:
            members = np.asarray(
                [n for nodes in self.clusters for n in nodes], dtype=np.int32
            )
            offsets = np.zeros(len(self.clusters) + 1, dtype=np.int32)
            offsets[1:] = np.cumsum([len(nodes) for nodes in self.clusters])
            cached = (members, offsets)
            object.__setattr__(self, "_flat_clusters", cached)
        return cached

    @classmethod
    def from_ligand(cls, ligand: Ligand) -> "PackedLigand":
        graph = ligand.graph
        if not graph.nodes:
            # featureless ligand: scores 0 (graph_match.py:95-99); packed as
            # an empty graph so batch assembly can skip it uniformly
            c = max(graph.num_conformers, 1)
            return cls(
                node_pos=np.zeros((0, c, 3), np.float32),
                node_mask=np.zeros(0, np.int32),
                clusters=[],
                cluster_mask=np.zeros(0, np.int32),
                cluster_center=np.zeros((0, c, 3), np.float32),
                cluster_size=np.zeros((0, c), np.float32),
                num_conformers=c,
            )
        node_pos = np.stack([node.positions for node in graph.nodes], axis=0).astype(
            np.float32
        )  # [Ln, C, 3]
        node_mask = np.array([_type_mask(n.types) for n in graph.nodes], dtype=np.int32)
        # sort clusters by priority; the depth cap is applied AFTER candidate
        # filtering in build_batch (graph_match.py:87-88 caps the filtered list)
        clusters_sorted = sorted(graph.node_clusters, key=priority_fn)
        clusters = [[n.index for n in c.nodes] for c in clusters_sorted]
        cluster_mask = np.array(
            [_type_mask(c.node_types) for c in clusters_sorted], dtype=np.int32
        )
        cluster_center = np.stack([c.center for c in clusters_sorted], axis=0).astype(
            np.float32
        )
        cluster_size = np.stack([c.size for c in clusters_sorted], axis=0).astype(np.float32)
        return cls(
            node_pos, node_mask, clusters, cluster_mask, cluster_center,
            cluster_size, graph.num_conformers,
        )


# ==========================================================================
# Batch assembly: flatten (ligand, cluster pair, uv, model pair) blocks
# ==========================================================================
@dataclass
class ScreenBatch:
    # sub-block arrays [NS, ...]
    sub_mu: np.ndarray  # [NS, P]
    sub_std: np.ndarray  # [NS, P]
    sub_w: np.ndarray  # [NS, P]  (0 = padding entry)
    sub_d_idx: np.ndarray  # [NS] into flattened distances [B*Ln*Ln]
    sub_block: np.ndarray  # [NS] block id
    # block arrays [NB]
    block_mn: np.ndarray  # [NB] M*N of the full block
    block_pair: np.ndarray  # [NB] pair id
    block_is_cross: np.ndarray  # [NB] 1 for cross-cluster pairs (fail logic)
    # pair arrays [NP]
    pair_threshold: np.ndarray  # [NP] fail threshold (n1*n2*0.5; inf for self)
    pair_meta: np.ndarray  # [NP, 6] (ligand, l1, l2, m1, m2, is_self)
    # ligand-level arrays
    node_pos: np.ndarray  # [B, Ln, C, 3]
    num_conformers: np.ndarray  # [B]
    lig_cluster_center: np.ndarray  # [B, L, C, 3]
    lig_cluster_size: np.ndarray  # [B, L, C]
    # host-side DFS metadata
    ligand_clusters: list  # per ligand: cluster count
    candidates: list  # per ligand: list per cluster of model cluster ids
    pair_slices: list  # per ligand: (start, end) into pair arrays
    ln: int
    cmax: int
    # [B, Ln] int32 per-node type bitmask (0 on padding nodes). Optional:
    # lets screen_v3 derive exact group keys from metadata instead of
    # hashing expanded [NB, R] float tables (see group_ids_meta).
    node_mask: np.ndarray | None = None


def build_batch(
    model: PackedModel,
    ligands: list[PackedLigand],
    ln: int | None = None,
    cmax: int | None = None,
    lmax: int | None = None,
    native: bool = True,
) -> ScreenBatch:
    """Flatten a ligand batch into device block arrays.

    native=True runs the C++ block packer (native/block_packer.cpp; a
    failed build raises); native=False runs the pure-Python path below,
    the semantic reference.
    """
    if native:
        return _build_batch_native(model, ligands, ln, cmax, lmax)
    return _build_batch_python(model, ligands, ln, cmax, lmax)


def _build_batch_python(
    model: PackedModel,
    ligands: list[PackedLigand],
    ln: int | None = None,
    cmax: int | None = None,
    lmax: int | None = None,
) -> ScreenBatch:
    """Flatten a ligand batch into device block arrays (host, numpy).

    ln/cmax/lmax fix the node/conformer/cluster padding (for multi-shard
    batches that must share shapes); default to the batch maxima.
    """
    num_types = len(PHARMACOPHORE_TYPES)
    sub_mu, sub_std, sub_w, sub_d, sub_block = [], [], [], [], []
    block_mn, block_pair, block_cross = [], [], []
    pair_threshold, pair_meta = [], []
    candidates_all, pair_slices, cluster_counts = [], [], []

    ln = ln or max(p.node_pos.shape[0] for p in ligands)
    cmax = cmax or max(p.num_conformers for p in ligands)

    for li, lig in enumerate(ligands):
        pair_start = len(pair_threshold)
        num_clusters = len(lig.clusters)
        cluster_counts.append(num_clusters)
        # candidate model clusters per ligand cluster (type overlap), then
        # cap the DFS depth over the FILTERED list (graph_match.py:87-88)
        cands = [
            [m for m in range(len(model.cluster_nodes)) if lig.cluster_mask[l] & model.cluster_mask[m]]
            for l in range(num_clusters)
        ]
        active = [l for l in range(num_clusters) if cands[l]][:MAX_MATCH_DEPTH]
        candidates_all.append((active, cands))

        # matched model nodes per (ligand node u, model cluster m): A(u, m)
        def matched(u: int, m: int) -> list[int]:
            out = []
            umask = lig.node_mask[u]
            for t in range(num_types):
                if umask & (1 << t):
                    out.extend(model.cluster_type_nodes[m][t])
            return out

        match_cache: dict[tuple[int, int], list[int]] = {}

        def get_matched(u: int, m: int) -> list[int]:
            key = (u, m)
            if key not in match_cache:
                match_cache[key] = matched(u, m)
            return match_cache[key]

        def emit_block(u: int, v: int, a_nodes: list[int], b_nodes: list[int], pair_id: int, cross: bool):
            mn = len(a_nodes) * len(b_nodes)
            block_id = len(block_mn)
            block_mn.append(mn)
            block_pair.append(pair_id)
            block_cross.append(1 if cross else 0)
            d_idx = li * ln * ln + u * ln + v
            # flatten (p, q) pairs and split into BLOCK_P sub-blocks
            pairs = [(p, q) for p in a_nodes for q in b_nodes]
            for s in range(0, len(pairs), BLOCK_P):
                chunk = pairs[s : s + BLOCK_P]
                mu_row = np.zeros(BLOCK_P, dtype=np.float32)
                std_row = np.ones(BLOCK_P, dtype=np.float32)
                w_row = np.zeros(BLOCK_P, dtype=np.float32)
                for k, (p, q) in enumerate(chunk):
                    mu_row[k] = model.mu[p, q]
                    std_row[k] = model.std[p, q]
                    w_row[k] = model.weight[p] * model.weight[q]
                sub_mu.append(mu_row)
                sub_std.append(std_row)
                sub_w.append(w_row)
                sub_d.append(d_idx)
                sub_block.append(block_id)

        # self pairs (l, l, m, m): combinations of nodes within the cluster
        for l in active:
            for m in cands[l]:
                pair_id = len(pair_threshold)
                pair_threshold.append(np.inf)
                pair_meta.append((li, l, l, m, m, 1))
                nodes_l = lig.clusters[l]
                matched_nodes = [
                    (u, get_matched(u, m)) for u in nodes_l if get_matched(u, m)
                ]
                for i in range(len(matched_nodes)):
                    for j in range(i + 1, len(matched_nodes)):
                        u, a_nodes = matched_nodes[i]
                        v, b_nodes = matched_nodes[j]
                        emit_block(u, v, a_nodes, b_nodes, pair_id, cross=False)

        # cross pairs over the active (filtered+capped) list, in order
        for i1 in range(len(active)):
            for i2 in range(i1 + 1, len(active)):
                l1, l2 = active[i1], active[i2]
                for m1 in cands[l1]:
                    for m2 in cands[l2]:
                        pair_id = len(pair_threshold)
                        m1_nodes = [
                            (u, get_matched(u, m1))
                            for u in lig.clusters[l1]
                            if get_matched(u, m1)
                        ]
                        m2_nodes = [
                            (v, get_matched(v, m2))
                            for v in lig.clusters[l2]
                            if get_matched(v, m2)
                        ]
                        pair_threshold.append(len(m1_nodes) * len(m2_nodes) * 0.5)
                        pair_meta.append((li, l1, l2, m1, m2, 0))
                        for u, a_nodes in m1_nodes:
                            for v, b_nodes in m2_nodes:
                                emit_block(u, v, a_nodes, b_nodes, pair_id, cross=True)
        pair_slices.append((pair_start, len(pair_threshold)))

    lmax = lmax or max(len(lig.clusters) for lig in ligands)
    node_pos, num_conf, lig_center, lig_size, node_mask_arr = _ligand_arrays(ligands, ln, cmax, lmax)

    return ScreenBatch(
        sub_mu=np.asarray(sub_mu, dtype=np.float32).reshape(-1, BLOCK_P),
        sub_std=np.asarray(sub_std, dtype=np.float32).reshape(-1, BLOCK_P),
        sub_w=np.asarray(sub_w, dtype=np.float32).reshape(-1, BLOCK_P),
        sub_d_idx=np.asarray(sub_d, dtype=np.int32),
        sub_block=np.asarray(sub_block, dtype=np.int32),
        block_mn=np.asarray(block_mn, dtype=np.int32),
        block_pair=np.asarray(block_pair, dtype=np.int32),
        block_is_cross=np.asarray(block_cross, dtype=np.int32),
        pair_threshold=np.asarray(pair_threshold, dtype=np.float32),
        pair_meta=np.asarray(pair_meta, dtype=np.int32).reshape(-1, 6),
        node_pos=node_pos,
        num_conformers=num_conf,
        lig_cluster_center=lig_center,
        lig_cluster_size=lig_size,
        ligand_clusters=cluster_counts,
        candidates=candidates_all,
        pair_slices=pair_slices,
        ln=ln,
        cmax=cmax,
        node_mask=node_mask_arr,
    )


def unique_distance_table(batch: ScreenBatch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique (ligand, u, v) rows referenced by sub-blocks.

    Returns (pair_u [NU], pair_v [NU] — global node rows into the flattened
    [B*Ln] position array — and sub_slot [NS] indices into that table).
    """
    ln = batch.ln
    # sort + searchsorted instead of np.unique(return_inverse=True): the
    # inverse via binary search skips the full argsort (~3x faster here)
    uniq = np.unique(batch.sub_d_idx)
    inverse = np.searchsorted(uniq, batch.sub_d_idx)
    li = uniq // (ln * ln)
    rem = uniq % (ln * ln)
    pair_u = (li * ln + rem // ln).astype(np.int32)
    pair_v = (li * ln + rem % ln).astype(np.int32)
    return pair_u, pair_v, inverse.astype(np.int32)


def segment_boundaries(ids: np.ndarray, num_segments: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ends, starts, has) for sorted segment ids (host, vectorized).

    Single-pass bincount/cumsum (O(N + S)) rather than per-segment
    searchsorted (O(S log N)): the segment count is comparable to the row
    count here, so this is the host-bandwidth-optimal form.
    """
    counts = np.bincount(ids, minlength=num_segments)[:num_segments]
    cum = np.cumsum(counts)
    ends = (cum - 1).astype(np.int32)
    starts = (cum - counts).astype(np.int32)
    has = counts > 0
    return ends, starts, has


def _ligand_arrays(ligands, ln, cmax, lmax):
    node_pos = np.zeros((len(ligands), ln, cmax, 3), dtype=np.float32)
    num_conf = np.zeros(len(ligands), dtype=np.int32)
    lig_center = np.zeros((len(ligands), lmax, cmax, 3), dtype=np.float32)
    lig_size = np.zeros((len(ligands), lmax, cmax), dtype=np.float32)
    node_mask = np.zeros((len(ligands), ln), dtype=np.int32)
    for li, lig in enumerate(ligands):
        n, c = lig.node_pos.shape[0], lig.num_conformers
        node_mask[li, :n] = lig.node_mask
        node_pos[li, :n, :c] = lig.node_pos
        # repeat last conformer into padding (keeps distances finite)
        if c < cmax:
            node_pos[li, :n, c:] = lig.node_pos[:, -1:, :]
        num_conf[li] = c
        num_l = len(lig.clusters)
        lig_center[li, :num_l, :c] = lig.cluster_center
        lig_size[li, :num_l, :c] = lig.cluster_size
        if c < cmax:
            lig_center[li, :num_l, c:] = lig.cluster_center[:, -1:]
            lig_size[li, :num_l, c:] = lig.cluster_size[:, -1:]
    return node_pos, num_conf, lig_center, lig_size, node_mask


@dataclass
class FlatLigands:
    """Flattened ligand metadata shared by the native packers."""

    ln: int
    cmax: int
    lmax: int
    lig_cluster_offsets: np.ndarray
    member_offsets: np.ndarray  # [C_total + 1]
    members: np.ndarray
    node_mask_offsets: np.ndarray
    node_masks_flat: np.ndarray
    active_offsets: np.ndarray
    active_flat: np.ndarray
    cand_offsets: np.ndarray  # [C_total + 1]
    cands_flat: np.ndarray
    candidates_all: list
    cluster_counts: list[int]


def _flatten_ligands(
    model: PackedModel,
    ligands: list[PackedLigand],
    ln: int | None = None,
    cmax: int | None = None,
    lmax: int | None = None,
) -> FlatLigands:
    num_ligands = len(ligands)
    ln = ln or max(p.node_pos.shape[0] for p in ligands)
    cmax = cmax or max(p.num_conformers for p in ligands)
    lmax = lmax or max(len(p.clusters) for p in ligands)

    lig_cluster_offsets = np.zeros(num_ligands + 1, dtype=np.int32)
    node_mask_offsets = np.zeros(num_ligands + 1, dtype=np.int32)
    active_offsets = np.zeros(num_ligands + 1, dtype=np.int32)
    member_arrays: list[np.ndarray] = []
    member_offset_arrays: list[np.ndarray] = []
    member_base = 0
    node_masks: list[np.ndarray] = []
    active_list: list[int] = []
    candidates_all = []
    cluster_counts = []
    model_masks = model.cluster_mask  # [M]

    # candidates via bitwise mask overlap, vectorized across the whole batch
    # (one [sum_L, M] pass instead of per-ligand nonzero calls)
    all_cluster_masks = np.concatenate(
        [lig.cluster_mask for lig in ligands]
    ) if ligands else np.zeros(0, np.int64)
    overlap_all = (all_cluster_masks[:, None] & model_masks[None, :]) != 0
    row_counts = overlap_all.sum(axis=1)
    nz_cols = np.nonzero(overlap_all)[1].astype(np.int64)
    row_offsets = np.concatenate([[0], np.cumsum(row_counts)])

    row = 0
    for li, lig in enumerate(ligands):
        num_l = len(lig.clusters)
        cluster_counts.append(num_l)
        members, offsets = lig.flat_clusters()
        member_arrays.append(members)
        member_offset_arrays.append(offsets[1:] + member_base)
        member_base += len(members)
        node_masks.append(lig.node_mask)
        cands = [
            nz_cols[row_offsets[row + l] : row_offsets[row + l + 1]]
            for l in range(num_l)
        ]
        active = [l for l in range(num_l) if row_counts[row + l]][:MAX_MATCH_DEPTH]
        candidates_all.append((active, cands))
        active_list.extend(active)
        row += num_l
        lig_cluster_offsets[li + 1] = lig_cluster_offsets[li] + num_l
        node_mask_offsets[li + 1] = node_mask_offsets[li] + len(lig.node_mask)
        active_offsets[li + 1] = len(active_list)

    member_offsets = (
        np.concatenate([np.zeros(1, np.int32), *member_offset_arrays])
        if member_offset_arrays else np.zeros(1, np.int32)
    ).astype(np.int32)
    return FlatLigands(
        ln=ln, cmax=cmax, lmax=lmax,
        lig_cluster_offsets=lig_cluster_offsets,
        member_offsets=member_offsets,
        members=np.concatenate(member_arrays).astype(np.int32)
        if member_arrays else np.zeros(0, np.int32),
        node_mask_offsets=node_mask_offsets,
        node_masks_flat=np.concatenate(node_masks).astype(np.int32)
        if node_masks else np.zeros(0, np.int32),
        active_offsets=active_offsets,
        active_flat=np.asarray(active_list, dtype=np.int32)
        if active_list else np.zeros(0, np.int32),
        cand_offsets=row_offsets.astype(np.int32),
        cands_flat=nz_cols.astype(np.int32)
        if len(nz_cols) else np.zeros(0, np.int32),
        candidates_all=candidates_all,
        cluster_counts=cluster_counts,
    )


def _build_batch_native(
    model: PackedModel,
    ligands: list[PackedLigand],
    ln: int | None = None,
    cmax: int | None = None,
    lmax: int | None = None,
) -> ScreenBatch:
    """C++ block emission; produces arrays identical to the Python path."""
    from ..native import get_block_packer

    fn = get_block_packer()
    num_ligands = len(ligands)
    fl = _flatten_ligands(model, ligands, ln, cmax, lmax)
    ln, cmax, lmax = fl.ln, fl.cmax, fl.lmax
    candidates_all = fl.candidates_all
    cluster_counts = fl.cluster_counts

    ct_offsets, ct_nodes = model.ct_tables()
    mu = np.ascontiguousarray(model.mu)
    std = np.ascontiguousarray(model.std)
    weight = np.ascontiguousarray(model.weight)

    cap_ns = max(4096, 2048 * num_ligands)
    cap_nb = cap_ns
    cap_np = max(1024, 1024 * num_ligands)
    while True:
        sub_mu = np.empty((cap_ns, BLOCK_P), dtype=np.float32)
        sub_std = np.empty((cap_ns, BLOCK_P), dtype=np.float32)
        sub_w = np.empty((cap_ns, BLOCK_P), dtype=np.float32)
        sub_d = np.empty(cap_ns, dtype=np.int32)
        sub_block = np.empty(cap_ns, dtype=np.int32)
        block_mn = np.empty(cap_nb, dtype=np.int32)
        block_pair = np.empty(cap_nb, dtype=np.int32)
        block_cross = np.empty(cap_nb, dtype=np.int32)
        pair_threshold = np.empty(cap_np, dtype=np.float32)
        pair_meta = np.empty((cap_np, 6), dtype=np.int32)
        pair_slices = np.zeros((num_ligands, 2), dtype=np.int64)
        counts = np.zeros(3, dtype=np.int64)
        rc = fn(
            len(model.cluster_nodes), len(model.weight),
            ct_offsets, ct_nodes, mu, std, weight,
            num_ligands, ln,
            fl.lig_cluster_offsets,
            fl.member_offsets,
            fl.members,
            fl.node_mask_offsets, fl.node_masks_flat,
            fl.active_offsets,
            fl.active_flat,
            fl.cand_offsets,
            fl.cands_flat,
            BLOCK_P, cap_ns, cap_nb, cap_np,
            sub_mu, sub_std, sub_w, sub_d, sub_block,
            block_mn, block_pair, block_cross,
            pair_threshold, pair_meta, pair_slices.reshape(-1), counts,
        )
        if rc == 0:
            break
        cap_ns *= 4
        cap_nb *= 4
        cap_np *= 4

    ns, nb, npairs = int(counts[0]), int(counts[1]), int(counts[2])
    node_pos, num_conf, lig_center, lig_size, node_mask_arr = _ligand_arrays(ligands, ln, cmax, lmax)
    return ScreenBatch(
        sub_mu=sub_mu[:ns], sub_std=sub_std[:ns], sub_w=sub_w[:ns],
        sub_d_idx=sub_d[:ns], sub_block=sub_block[:ns],
        block_mn=block_mn[:nb], block_pair=block_pair[:nb],
        block_is_cross=block_cross[:nb],
        pair_threshold=pair_threshold[:npairs], pair_meta=pair_meta[:npairs],
        node_pos=node_pos, num_conformers=num_conf,
        lig_cluster_center=lig_center, lig_cluster_size=lig_size,
        ligand_clusters=cluster_counts, candidates=candidates_all,
        pair_slices=[(int(a), int(b)) for a, b in pair_slices],
        ln=ln, cmax=cmax,
        node_mask=node_mask_arr,
    )


# ==========================================================================
# Device half (plain torch; the "reference" engine)
# ==========================================================================
def _shift_right(a: torch.Tensor, shift: int, fill) -> torch.Tensor:
    """a shifted right by `shift` along its last axis, `fill` shifted in."""
    n = a.shape[-1]
    head = torch.full((*a.shape[:-1], min(shift, n)), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([head, a[..., : max(n - shift, 0)]], dim=-1)


def _bounded_segmented_scan(x: torch.Tensor, flags: torch.Tensor, depth: int) -> torch.Tensor:
    """Segmented inclusive scan of x [C, N] along the minor axis, for
    segments of length <= 2^depth (Hillis-Steele with boundary flags
    [N] bool, True at each segment's first row).

    The batch's segments (sub-rows per block, sub-rows per pair) are a few
    rows long, so a few shift-add passes replace a full log2(N)-deep scan.
    """
    val = x
    seen = flags
    shift = 1
    for _ in range(depth):
        val_s = _shift_right(val, shift, 0.0)
        seen_s = _shift_right(seen, shift, True)
        val = val + torch.where(seen, 0.0, val_s)
        seen = seen | seen_s
        shift *= 2
    return val


def scan_fail(
    sub_scores: torch.Tensor,  # [C, NS]
    sub_pass: torch.Tensor,  # [C, NS]
    flags_block: torch.Tensor,  # [NS] bool
    flags_pair: torch.Tensor,  # [NS] bool
    end_mn_inv: torch.Tensor,
    end_mn_half: torch.Tensor,
    end_fail_gate: torch.Tensor,
    thr_ns: torch.Tensor,
    self_ns: torch.Tensor,  # [NS] bool
    depth1: int,
    depth2: int,
) -> torch.Tensor:
    """The scan and fail phase shared by score_blocks_device and the split
    (Gaussian kernel + torch scans) route: sub -> block scans, block score
    and fail, block -> pair scans, then -1 where a cross pair fails.
    Returns the expanded [C, NS] table."""
    scan_s = _bounded_segmented_scan(sub_scores, flags_block, depth1)
    scan_p = _bounded_segmented_scan(sub_pass, flags_block, depth1)
    block_score_ns = scan_s * end_mn_inv[None, :]  # 0 off block ends
    block_fail_ns = torch.where(
        scan_p < end_mn_half[None, :], end_fail_gate[None, :], 0.0
    )
    pair_score_ns = _bounded_segmented_scan(block_score_ns, flags_pair, depth2)
    pair_fail_ns = _bounded_segmented_scan(block_fail_ns, flags_pair, depth2)
    failed = pair_fail_ns > thr_ns[None, :]
    return torch.where(failed & (~self_ns[None, :]), -1.0, pair_score_ns)


def score_blocks_device(
    node_pos: torch.Tensor,  # [B, Ln, C, 3]
    sub_mu: torch.Tensor,  # [P, NS] (host-pretransposed, lane-major)
    sub_inv: torch.Tensor,  # [P, NS]  (1/std; 1.0 padding)
    sub_winv: torch.Tensor,  # [P, NS]  (w/std; 0.0 padding)
    pair_u: torch.Tensor,  # [NU] global node row of u per unique (lig, u, v)
    pair_v: torch.Tensor,  # [NU]
    sub_slot: torch.Tensor,  # [NS] index into the unique-distance table
    flags_block: torch.Tensor,  # [NS] bool — first sub row of each block
    flags_pair: torch.Tensor,  # [NS] bool — first sub row of each pair
    end_mn_inv: torch.Tensor,  # [NS] f32 — 1/(M*N) at block-end rows, 0 elsewhere
    end_mn_half: torch.Tensor,  # [NS] f32 — (M*N+1)//2 at block ends, 0 elsewhere
    end_fail_gate: torch.Tensor,  # [NS] f32 — 1 at block ends of cross pairs
    thr_ns: torch.Tensor,  # [NS] pair fail threshold expanded to sub rows
    self_ns: torch.Tensor,  # [NS] bool — pair is_self expanded to sub rows
    depth1: int,
    depth2: int,
) -> torch.Tensor:
    """Returns the EXPANDED score array [C, NS]: the final per-pair scores
    (-1 for failed conformers) sit at each pair's last sub row; the host
    compacts them. The plain-torch engine ("reference"): a unique-distance
    table, one gather to the rows, the Gaussian terms over [P, C, NS], and
    the bounded scans. The geometric prune is applied on the host."""
    b, ln, c, _ = node_pos.shape
    pos_flat = node_pos.reshape(b * ln, c, 3)
    dvec = pos_flat[pair_u.long()] - pos_flat[pair_v.long()]  # [NU, C, 3]
    dx, dy, dz = dvec[..., 0], dvec[..., 1], dvec[..., 2]
    d_table = torch.sqrt((dx * dx + dy * dy) + dz * dz)  # [NU, C]

    dT = d_table[sub_slot.long()].T  # [C, NS]
    x = (dT[None] - sub_mu[:, None, :]) * sub_inv[:, None, :]  # [P, C, NS]
    x2 = x * x
    valid = sub_winv[:, None, :] > 0.0
    gauss = torch.where(valid, sub_winv[:, None, :] * torch.exp(-0.5 * x2), 0.0)
    sub_scores = torch.sum(gauss, dim=0)  # [C, NS]
    sub_pass = torch.sum(torch.where(valid & (x2 < 4.0), 1.0, 0.0), dim=0)
    return scan_fail(
        sub_scores, sub_pass, flags_block, flags_pair, end_mn_inv,
        end_mn_half, end_fail_gate, thr_ns, self_ns, depth1, depth2,
    )


def compact_pair_table(batch: ScreenBatch, expanded: np.ndarray) -> np.ndarray:
    """Gather per-pair scores [NP, C] out of the expanded [C, NS] device
    output (host-side vectorized numpy; empty pairs score 0)."""
    np_real = len(batch.pair_threshold)
    sub_pair = (
        batch.block_pair[batch.sub_block]
        if len(batch.sub_block)
        else np.zeros(0, np.int32)
    )
    ends, _, has = segment_boundaries(sub_pair, np_real)
    table = expanded[:, np.clip(ends, 0, None)].T.copy()  # [NP, C]
    table[~has] = 0.0
    return table


def compact_pair_table_rows(rows: np.ndarray, pair_end_rows: np.ndarray) -> np.ndarray:
    """Row-major pair compaction: gather [NP, C] from the device's
    [NST, C] output at the (ascending) pair-end rows; empty pairs (-1)
    score 0. The row-major layout makes this sequential 16-byte reads."""
    table = rows[np.clip(pair_end_rows, 0, None)]
    table[pair_end_rows < 0] = 0.0
    return table


def compact_pair_table_tiled(expanded: np.ndarray, pair_end_rows: np.ndarray) -> np.ndarray:
    """Gather per-pair scores [NP, C] from the tiled expanded output using
    the layout's precomputed pair-end rows (empty pairs score 0)."""
    table = expanded[:, np.clip(pair_end_rows, 0, None)].T.copy()
    table[pair_end_rows < 0] = 0.0
    return table


def host_prune_mask(
    batch: ScreenBatch, model: PackedModel, native: bool = True
) -> np.ndarray:
    """Geometric feasibility prune per pair (graph_match.py:267), computed
    on the host (static per batch): True where the pair must score -1.

    native=True runs native/prep_args.cpp prune_pairs; native=False the
    numpy reference below."""
    meta = batch.pair_meta
    if len(meta) == 0:
        return np.zeros(0, dtype=bool)
    if native:
        from ..native import get_prune_pairs

        np_real = len(meta)
        lmax = batch.lig_cluster_center.shape[1]
        cmax = batch.lig_cluster_center.shape[2]
        pruned = np.empty(np_real, dtype=bool)
        get_prune_pairs()(
            np_real, cmax, lmax,
            np.ascontiguousarray(meta),
            np.ascontiguousarray(batch.lig_cluster_center),
            np.ascontiguousarray(batch.lig_cluster_size),
            np.ascontiguousarray(model.cluster_center),
            np.ascontiguousarray(model.cluster_size),
            pruned,
        )
        return pruned
    li, l1, l2 = meta[:, 0], meta[:, 1], meta[:, 2]
    m1, m2, is_self = meta[:, 3], meta[:, 4], meta[:, 5] == 1
    lc1 = batch.lig_cluster_center[li, l1]  # [NP, C, 3]
    lc2 = batch.lig_cluster_center[li, l2]
    lig_dist = np.linalg.norm(lc1 - lc2, axis=-1)  # [NP, C]
    lig_size = batch.lig_cluster_size[li, l1] + batch.lig_cluster_size[li, l2]
    model_dist = np.linalg.norm(
        model.cluster_center[m1] - model.cluster_center[m2], axis=-1
    )
    model_size = model.cluster_size[m1] + model.cluster_size[m2]
    pruned = np.min(np.abs(lig_dist - model_dist[:, None]) - lig_size, axis=-1) > model_size
    return pruned & (~is_self)


# ==========================================================================
# Host DFS + end-to-end screening
# ==========================================================================
def _dfs_scores(
    batch: ScreenBatch, table: np.ndarray, threads: int = 1
) -> list[float]:
    """Run the assignment tree per ligand from the device table, in the C++
    DFS (native/match_dfs.cpp; _dfs_scores_python is the semantic
    reference). threads > 1 shards the per-ligand searches over a thread
    pool (independent searches, bit-identical scores at any thread count).
    Span `pmnet.tail.dfs`, counter `pmnet.dfs_ligands` (utils/profiling.py).
    """
    with profiling.span("pmnet.tail.dfs"):
        out = _run_dfs(batch, table, threads)
    profiling.count("pmnet.dfs_ligands", len(out))
    return [float(v) for v in out]


def _run_dfs(batch: ScreenBatch, table: np.ndarray, threads: int) -> np.ndarray:
    from ..native import get_match_dfs, get_match_dfs_mt

    cached = getattr(batch, "dfs_arrays", None)
    if cached is not None:
        # tile-store batches carry the arrays below, converted at prepack
        pair_starts, conformers, active_offsets, cand_counts = (
            np.ascontiguousarray(a) for a in cached
        )
    else:
        pair_starts = np.array([s for s, _ in batch.pair_slices], dtype=np.int64)
        conformers = batch.num_conformers.astype(np.int32)[: len(batch.ligand_clusters)]
        offsets = [0]
        counts: list[int] = []
        for active, cands in batch.candidates:
            counts.extend(len(cands[l]) for l in active)
            offsets.append(len(counts))
        active_offsets = np.asarray(offsets, dtype=np.int32)
        cand_counts = np.asarray(counts, dtype=np.int32)
    num = len(conformers)
    out = np.zeros(num, dtype=np.float32)
    table_c = np.ascontiguousarray(table, dtype=np.float32)
    args = (
        num, table_c, table_c.shape[1], pair_starts,
        np.ascontiguousarray(conformers, dtype=np.int32), active_offsets,
        cand_counts if len(cand_counts) else np.zeros(0, np.int32), out,
    )
    if threads > 1:
        get_match_dfs_mt()(*args, threads)
    else:
        get_match_dfs()(*args)
    return out


def _dfs_scores_python(batch: ScreenBatch, table: np.ndarray) -> list[float]:
    """Reference Python implementation of the assignment DFS."""
    out = []
    for li in range(len(batch.ligand_clusters)):
        start, end = batch.pair_slices[li]
        active, cands = batch.candidates[li]
        c = int(batch.num_conformers[li])
        if not active:
            out.append(0.0)
            continue
        pair_table: dict = {}
        for p in range(start, end):
            _, l1, l2, m1, m2, _ = batch.pair_meta[p]
            pair_table.setdefault((int(l1), int(l2)), {})[(int(m1), int(m2))] = tuple(
                table[p, :c].tolist()
            )
        cluster_match_dict = {l: cands[l] for l in active}
        root = ClusterMatchTreeRoot(active, cluster_match_dict, pair_table, c)
        root.run()
        scores = np.zeros(c)
        for leaf in root.iteration_leaf():
            for conf, score in leaf.pair_scores.items():
                if score > scores[conf]:
                    scores[conf] = score
        out.append(float(np.mean(scores)))
    return out


def _bucket_up(n: int, minimum: int = 1024) -> int:
    """Round up to the next half-octave bucket (1024, 1536, 2048, 3072, ...).

    Bounds the number of distinct padded widths (buffer-cache reuse) while
    capping pad waste at 50% — pad rows are streamed like real ones."""
    size = minimum
    while size < n:
        if size + size // 2 >= n:
            return size + size // 2
        size *= 2
    return size


def _used_tiles(tb) -> int:
    """Tiles of a K1/K3 batch that go to the device: those up to the last
    row (a fresh pack's nst) or the last pair end (a store batch). The
    padding after them is neutral and no pair ends there."""
    from .screen_tiles import TILE

    nst = getattr(tb, "nst", None)
    if nst is None:
        return int(tb.pair_end_rows.max(initial=0)) // TILE + 1
    return max(1, -(-nst // TILE))


class BatchScreener:
    """Screens ligand batches against one pharmacophore model on one torch
    device.

    engine "tiled" (default): the fused tile kernels — K1
    (score_tiles_fused_rows) over the one-pass native pack; with
    native_pack=False, K4 (score_blocks_fused) over the build_batch +
    screen_tiles layout; with fused=False, K5 (gaussian_phase) plus the
    torch scans.
    engine "v3": K2 (score_tiles_v3) over the screen_v3 layout.
    engine "reference": score_blocks_device, in plain torch.
    Tile-store batches (score_stored) run K2 (v3 stores), K3 (v2 stores,
    score_tiles_fused_dt) or K1 (v1 stores) whatever the engine. On a
    CUDA device each kernel is the hand-written one of ops/screen_cuda.py,
    on the CPU its plain torch twin.

    device defaults to "cuda" and raises when no card is visible.
    """

    ENGINES = ("tiled", "v3", "reference")

    def __init__(
        self,
        model,
        weights: dict[str, float] | None = None,
        engine: str = "tiled",
        fused: bool = True,
        native_pack: bool = True,
        pack_threads: int = 1,
        device: str | torch.device = "cuda",
    ):
        if isinstance(model, PackedModel):
            if weights is not None:
                raise ValueError("weights are baked into a PackedModel")
            self.packed_model = model
        else:
            self.packed_model = PackedModel.from_model(model, weights)
        if engine not in self.ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of {self.ENGINES}")
        self.engine = engine
        self.fused = fused
        self.native_pack = native_pack
        self.pack_threads = pack_threads
        self.device = resolve_device(device)
        # device work runs on this stream, from whichever thread launches it
        self.stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        # page-locked ring for the read-only arrays copied to the card
        self._staging = (
            staging.PinnedStaging(self.device, self.stream, threads=pack_threads)
            if self.stream is not None else None
        )
        self._rows_hint: float = 600.0  # running rows-per-ligand estimate
        self._pack_buffers: dict = {}  # reused tiled-pack output arrays

    @property
    def uses_tiled_pack(self) -> bool:
        """True when batches go through the one-pass pack and K1."""
        return self.engine == "tiled" and self.fused and self.native_pack

    def _to_device(self, a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Host array -> tensor on the screener's device. `a` has been read
        in full when this returns, so a pack buffer may be reused as soon
        as the launch is queued. On a card a read-only array (a store
        mapping) is staged (`staging.stages`): span
        `pmnet.dispatch.copy_out` times the memcpy from the mapping into
        the screener's page-locked ring and `pmnet.dispatch.h2d` the copy
        queued on its stream, which runs on behind the return (counter
        `pmnet.h2d_staged_bytes`). Any other array is copied from pageable
        memory, a read-only one (on the CPU) first copied out with
        `np.array` (`pmnet.dispatch.copy_out`), and `pmnet.dispatch.h2d`
        times the copy to the device. Counters `pmnet.copy_out_bytes`
        (read-only arrays) and `pmnet.h2d_bytes` (every array)."""
        a = np.asarray(a)
        if staging.stages(a, self.device):
            t = self._staging.to_device(a, dtype)
            profiling.count("pmnet.h2d_bytes", a.nbytes)
            return t
        if not a.flags.writeable:  # a read-only array: copy it out
            with profiling.span("pmnet.dispatch.copy_out"):
                a = np.array(a)
            profiling.count("pmnet.copy_out_bytes", a.nbytes)
        t = torch.from_numpy(np.ascontiguousarray(a))
        with profiling.span("pmnet.dispatch.h2d"):
            t = t.to(self.device, dtype=dtype)
        profiling.count("pmnet.h2d_bytes", a.nbytes)
        return t

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Device result -> numpy, copied on the stream that produced it
        (span `pmnet.tail.d2h`: the wait for the card, then the copy)."""
        with self._device_scope(), profiling.span("pmnet.tail.d2h"):
            return t.cpu().numpy()

    def _device_scope(self):
        """Make the screener's stream (and device) current; no-op on CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def score_ligands(self, ligands: list[Ligand]) -> list[float]:
        packed = [PackedLigand.from_ligand(lig) for lig in ligands]
        return self.score_packed(packed)

    def score_packed(self, packed: list[PackedLigand]) -> list[float]:
        # ligands with no clusters score 0 (graph_match.py:95-99)
        live = [(i, p) for i, p in enumerate(packed) if p.clusters]
        out = [0.0] * len(packed)
        if not live:
            return out
        scores = self.dispatch_live([p for _, p in live])()
        for (i, _), s in zip(live, scores):
            out[i] = s
        return out

    def dispatch_live(self, live: list[PackedLigand], cmax: int | None = None):
        """Host pack and kernel launch of one batch of ligands that have
        clusters (asynchronous on the card), by engine: the one-pass C++
        pack + K1; build_batch + the K4 or K5 tiled layout; the v3 layout +
        K2; or build_batch + score_blocks_device. `cmax` pins the conformer
        slots. Returns the host tail: a call that gives the ligands'
        scores. A one-pass pack aliases this screener's buffer cache, so
        call the tail before the next pack."""
        if self.uses_tiled_pack:
            from .tiled_pack import build_tiled_batch

            tb = build_tiled_batch(
                self.packed_model, live, threads=self.pack_threads,
                rows_hint=int(self._rows_hint * len(live)),
                buffer_cache=self._pack_buffers, cmax=cmax,
            )
            self._rows_hint = 0.7 * self._rows_hint + 0.3 * (tb.nst / max(1, len(live)))
            return functools.partial(self.postprocess_tb, tb, self.dispatch_tb(tb))
        batch = build_batch(self.packed_model, live, cmax=cmax)
        if self.engine == "v3":
            vb = self.build_vb(batch)
            return functools.partial(self.postprocess_vb, vb, self.dispatch_vb(vb))
        if self.engine == "tiled":
            tiled = self.device_args_tiled(batch)
            return functools.partial(self.postprocess_expanded, batch,
                                     self.run_device_tiled(tiled), tiled.pair_end_rows)
        return functools.partial(self.postprocess_expanded, batch, self.run_device(batch))

    def postprocess_expanded(self, batch: ScreenBatch, expanded_dev: torch.Tensor,
                             pair_end_rows: np.ndarray | None = None) -> list[float]:
        """Host tail for an expanded [C, NS] table (K4, K5 + scans, or
        score_blocks_device): pair compaction (at the tiled layout's
        pair-end rows where given), the geometric prune and the DFS."""
        expanded = self._to_host(expanded_dev)
        if pair_end_rows is None:
            table = compact_pair_table(batch, expanded)
        else:
            table = compact_pair_table_tiled(expanded, pair_end_rows)
        # geometric prune (host, static per batch; graph_match.py:267)
        prune = host_prune_mask(batch, self.packed_model)
        table[: len(prune)][prune] = -1.0
        return _dfs_scores(batch, table, threads=self.pack_threads)

    def dispatch_tb(self, tb) -> torch.Tensor:
        """Launch K1 on a packed tiled batch or a v1 store batch
        (asynchronous on the card). Returns the [T*1024, C] rows on the
        screener's device."""
        t = _used_tiles(tb)
        with self._device_scope():
            return screen_cuda.score_tiles_fused_rows(
                self._to_device(tb.pos_blocks[:t]), self._to_device(tb.uv[:t]),
                self._to_device(tb.gtab[:t]), self._to_device(tb.aux[:t]),
                depth1=tb.depth1, depth2=tb.depth2,
            )

    def postprocess_tb(self, tb, rows_dev: torch.Tensor) -> list[float]:
        """Host tail for one tiled batch: pair compaction (ascending
        C-contiguous row reads), prune, and the assignment DFS."""
        table = compact_pair_table_rows(self._to_host(rows_dev), tb.pair_end_rows)
        prune = host_prune_mask(tb, self.packed_model)
        table[: len(prune)][prune] = -1.0
        return _dfs_scores(tb, table, threads=self.pack_threads)

    def score_tb(self, tb) -> list[float]:
        """Device + host tail for one packed tiled batch."""
        return self.postprocess_tb(tb, self.dispatch_tb(tb))

    # ------------------------------------------------------------------
    # v3 engine (block-major rows + deduplicated group tables;
    # scoring/screen_v3.py + K2)
    # ------------------------------------------------------------------
    def build_vb(self, batch: ScreenBatch):
        """v3 layout with shape buckets: rows pad to the half-octave tile
        grid, the in-kernel mn axis to a half-octave of 8, and the pair-end
        rows (for compaction on the device) to a half-octave of 1024."""
        from .screen_tiles import TILE
        from .screen_v3 import build_v3_layout, pad_v3, padded_ends

        mn_max = int(batch.block_mn.max(initial=1))
        vb = build_v3_layout(
            batch, mn_cap=_bucket_up(mn_max, 8), model=self.packed_model
        )
        t = vb.dt.shape[0]
        t_bucket = -(-_bucket_up(max(vb.nbt, 1), TILE) // TILE)
        if t_bucket > t:
            vb = pad_v3(vb, t_bucket)
        vb.ends_padded = padded_ends(
            vb.pair_end_rows, _bucket_up(max(len(vb.pair_end_rows), 1))
        )
        return vb

    def _v3_args(self, b) -> tuple:
        return (self._to_device(b.dt), self._to_device(b.gid),
                self._to_device(b.tab), self._to_device(b.aux))

    def dispatch_vb(self, vb) -> torch.Tensor:
        """Launch K2 on a v3 batch (asynchronous on the card). With
        ends_padded set, pair compaction happens on the device and this
        returns the [NPpad, C] pair table; otherwise the [T*1024, C] rows
        for host compaction."""
        with self._device_scope():
            args = self._v3_args(vb)
            if vb.ends_padded is not None:
                return screen_cuda.score_tiles_v3_pairs(
                    *args, self._to_device(vb.ends_padded), depth=vb.depth,
                    mn_cap=vb.mn_cap,
                )
            return screen_cuda.score_tiles_v3_rows(*args, depth=vb.depth, mn_cap=vb.mn_cap)

    def _pair_table(self, b, rows_dev: torch.Tensor) -> np.ndarray:
        """[NP, C] host pair table from a device result: the compacted
        pair rows (ends_padded set) or the full rows, compacted here;
        empty pairs score 0."""
        if getattr(b, "ends_padded", None) is not None:
            table = self._to_host(rows_dev)[: len(b.pair_end_rows)].copy()
            table[b.pair_end_rows < 0] = 0.0
            return table
        return compact_pair_table_rows(self._to_host(rows_dev), b.pair_end_rows)

    def postprocess_vb(self, vb, rows_dev: torch.Tensor) -> list[float]:
        """Host tail for one v3 batch: pair table, prune, DFS."""
        table = self._pair_table(vb, rows_dev)
        prune = host_prune_mask(vb, self.packed_model)
        table[: len(prune)][prune] = -1.0
        return _dfs_scores(vb, table, threads=self.pack_threads)

    # ------------------------------------------------------------------
    # tile-store batches (scoring/tiled_store.py)
    # ------------------------------------------------------------------
    def dispatch_stored(self, sb):
        """Launch the kernels of one tile-store batch (asynchronous on the
        card). Returns what postprocess_stored takes:
          v3 + leaf buckets / single-window leaves: ([B] scores, outlier
            pair rows) from K2 and the torch leaf chain;
          v3 with padded pair-end rows: the [NPpad, C] pair table (K2 +
            compaction on the device);
          v3 without them: K2's [T*1024, C] rows;
          v2 (dt.npy): K3's rows; v1 (no dt.npy): K1's rows, over the
          tiles that hold pair ends.
        Span `pmnet.dispatch`: its self time is the host's launches."""
        with profiling.span("pmnet.dispatch", batch=sb.index):
            if getattr(sb, "gid", None) is not None:
                with self._device_scope():
                    return self._dispatch_stored_v3(sb)
            if sb.dt is None:
                return self.dispatch_tb(sb)
            t = _used_tiles(sb)
            with self._device_scope():
                return screen_cuda.score_tiles_fused_dt_rows(
                    self._to_device(sb.dt[:t]), self._to_device(sb.gtab[:t]),
                    self._to_device(sb.aux[:t]), depth1=sb.depth1, depth2=sb.depth2,
                )

    def _dispatch_stored_v3(self, sb):
        from .leaf_tree import leaf2_scores_device, leaf2_scores_multi

        if sb.leaf_buckets is None and sb.leaf2_ps is None:
            return self.dispatch_vb(sb)
        rows = screen_cuda.score_tiles_v3_rows(
            *self._v3_args(sb), depth=sb.depth, mn_cap=sb.mn_cap
        )
        if sb.leaf_buckets is not None:
            buckets = tuple(tuple(self._to_device(a) for a in b) for b in sb.leaf_buckets)
            return leaf2_scores_multi(
                rows, self._to_device(sb.leaf2_out_ends), buckets, nb=sb.leaf_nb
            )
        return leaf2_scores_device(
            rows, *(self._to_device(a) for a in (
                sb.leaf2_ends, sb.leaf2_ps, sb.leaf2_pc, sb.leaf2_pw,
                sb.leaf_conf, sb.leaf2_out_ends)),
        )

    def postprocess_stored(self, sb, result) -> list[float]:
        """Host tail for a tile-store batch, in batch order (cluster-less
        ligands score 0). Leaf-baked batches hand the final live scores
        plus the outlier rows, which get a host DFS over their few
        ligands; the others a pair table for the C++ DFS, with the prune
        mask and DFS arrays precomputed at prepack time. Span `pmnet.tail`."""
        with profiling.span("pmnet.tail", batch=sb.index):
            return self._stored_scores(sb, result)

    def _stored_scores(self, sb, result) -> list[float]:
        scores = [0.0] * sb.batch_len
        if getattr(sb, "leaf2_ps", None) is not None or getattr(sb, "leaf_buckets", None) is not None:
            dev_scores, out_rows = result
            for i, s in zip(sb.live_index, self._to_host(dev_scores).astype(np.float64)):
                scores[int(i)] = float(s)
            o = sb.leaf2_out
            if len(o["live"]):
                # heavy-tail ligands above the baked caps: host DFS over
                # their device-gathered sub-table (empty pairs already 0.0
                # via the zero row; prune applied here)
                n_rows = int(o["n_rows"])
                tbl = self._to_host(out_rows)[:n_rows].copy()
                tbl[o["prune"][:n_rows]] = -1.0
                duck = types.SimpleNamespace(dfs_arrays=(
                    o["pair_starts"], o["conformers"], o["active_offsets"],
                    o["cand_counts"]))
                out_scores = _dfs_scores(duck, tbl, threads=self.pack_threads)
                for k, li in enumerate(o["live"]):
                    scores[int(sb.live_index[int(li)])] = float(out_scores[k])
            return scores
        if getattr(sb, "pair_end_rows", 0) is None:
            # a leaf-baked load deferred the DFS-tail fields
            sb.ensure_host_fields()
        table = self._pair_table(sb, result)
        table[: len(sb.prune)][sb.prune] = -1.0
        live_scores = _dfs_scores(sb, table, threads=self.pack_threads)
        for i, s in zip(sb.live_index, live_scores):
            scores[int(i)] = s
        return scores

    def score_stored(self, sb) -> list[float]:
        """Device + host tail for one StoredBatch / StoredV3Batch."""
        if sb.empty:
            return [0.0] * sb.batch_len
        return self.postprocess_stored(sb, self.dispatch_stored(sb))

    def device_args_tiled(self, batch: ScreenBatch, ns_tiled: int | None = None):
        """Host prep for the K4/K5 routes: untiled lane-major prep (without
        the unique-distance table) + the tiled re-layout, as wide as its
        rows need unless `ns_tiled` pins the width."""
        from .screen_tiles import build_tiled_layout

        args, (d1, d2) = self.device_args(batch, with_unique=False)
        return build_tiled_layout(batch, args, (d1, d2), ns_tiled=ns_tiled)

    def run_device_tiled(self, tiled) -> torch.Tensor:
        """K4 (fused) or K5 + torch scans (fused=False) on a tiled layout.
        Returns the expanded [C, NS] table on the screener's device."""
        f32 = torch.float32
        with self._device_scope():
            pos = self._to_device(tiled.pos_blocks)
            uv = self._to_device(tiled.uv_packed)
            mu = self._to_device(tiled.muT)
            inv = self._to_device(tiled.invT)
            winv = self._to_device(tiled.winvT)
            if self.fused:
                rows = [
                    self._to_device(a, f32) for a in (
                        tiled.flags_block, tiled.flags_pair, tiled.end_mn_inv,
                        tiled.end_mn_half, tiled.end_fail_gate, tiled.thr_ns,
                        tiled.self_ns,
                    )
                ]
                return screen_cuda.score_blocks_fused(
                    pos, uv, mu, inv, winv, *rows,
                    depth1=tiled.depth1, depth2=tiled.depth2,
                )
            sp = screen_cuda.gaussian_phase(pos, uv, mu, inv, winv)
            c = sp.shape[0] // 2
            return scan_fail(
                sp[:c], sp[c:],
                self._to_device(tiled.flags_block),
                self._to_device(tiled.flags_pair),
                self._to_device(tiled.end_mn_inv),
                self._to_device(tiled.end_mn_half),
                self._to_device(tiled.end_fail_gate),
                self._to_device(tiled.thr_ns),
                self._to_device(tiled.self_ns),
                tiled.depth1, tiled.depth2,
            )

    def device_args(
        self,
        batch: ScreenBatch,
        native: bool = True,
        with_unique: bool = True,
    ) -> tuple[tuple, tuple[int, int]]:
        """Host prep (numpy) for score_blocks_device: returns (args,
        (depth1, depth2)) with the row axis padded to a half-octave bucket
        and depths from the longest block / pair span.

        native=True runs the fused C++ prep (native/prep_args.cpp);
        native=False the numpy path below, the semantic reference.
        """
        ns_real = len(batch.sub_d_idx)
        np_real = len(batch.pair_threshold)
        ns = _bucket_up(ns_real, minimum=1024)
        nb = len(batch.block_mn)

        if with_unique:
            pair_u, pair_v, sub_slot = unique_distance_table(batch)
            sub_slot = np.pad(sub_slot, (0, ns - ns_real))
        else:
            # the tiled kernels rebuild distances from per-tile node
            # tables — skip the np.unique pass entirely
            pair_u = pair_v = np.zeros(1, np.int32)
            sub_slot = np.zeros(ns, np.int32)

        if native:
            from ..native import get_prep_args

            muT = np.empty((BLOCK_P, ns), dtype=np.float32)
            invT = np.empty((BLOCK_P, ns), dtype=np.float32)
            winvT = np.empty((BLOCK_P, ns), dtype=np.float32)
            flags_block = np.empty(ns, dtype=bool)
            flags_pair = np.empty(ns, dtype=bool)
            end_mn_inv = np.empty(ns, dtype=np.float32)
            end_mn_half = np.empty(ns, dtype=np.float32)
            end_fail_gate = np.empty(ns, dtype=np.float32)
            thr_ns = np.empty(ns, dtype=np.float32)
            self_ns = np.empty(ns, dtype=bool)
            out_max = np.zeros(2, dtype=np.int64)
            get_prep_args()(
                ns_real, ns, nb, np_real, BLOCK_P,
                np.ascontiguousarray(batch.sub_mu),
                np.ascontiguousarray(batch.sub_std),
                np.ascontiguousarray(batch.sub_w),
                np.ascontiguousarray(batch.sub_block),
                np.ascontiguousarray(batch.block_pair),
                np.ascontiguousarray(batch.block_mn),
                np.ascontiguousarray(batch.block_is_cross),
                np.ascontiguousarray(batch.pair_threshold),
                np.ascontiguousarray(batch.pair_meta[:, 5])
                if np_real else np.zeros(0, np.int32),
                muT, invT, winvT, flags_block, flags_pair,
                end_mn_inv, end_mn_half, end_fail_gate, thr_ns, self_ns,
                out_max,
            )
            max_block = max(1, int(out_max[0]))
            max_pair = max(1, int(out_max[1]))
        else:
            # lane-major gaussian inputs (device never transposes)
            muT = np.zeros((BLOCK_P, ns), dtype=np.float32)
            invT = np.ones((BLOCK_P, ns), dtype=np.float32)
            winvT = np.zeros((BLOCK_P, ns), dtype=np.float32)
            muT[:, :ns_real] = batch.sub_mu.T
            invT[:, :ns_real] = (1.0 / batch.sub_std).T
            winvT[:, :ns_real] = (batch.sub_w / batch.sub_std).T

            # segment flags + block-end annotations over the NS axis
            sub_block = batch.sub_block
            sub_pair = (
                batch.block_pair[sub_block] if len(sub_block) else np.zeros(0, np.int32)
            )
            flags_block = np.ones(ns, dtype=bool)
            flags_pair = np.ones(ns, dtype=bool)
            if ns_real:
                flags_block[1:ns_real] = sub_block[1:] != sub_block[:-1]
                flags_pair[1:ns_real] = sub_pair[1:] != sub_pair[:-1]

            block_ends, _, _ = segment_boundaries(sub_block, nb)  # [NB] sub rows
            end_mn_inv = np.zeros(ns, dtype=np.float32)
            end_mn_half = np.zeros(ns, dtype=np.float32)
            end_fail_gate = np.zeros(ns, dtype=np.float32)
            end_mn_inv[block_ends] = 1.0 / np.maximum(batch.block_mn, 1)
            end_mn_half[block_ends] = (batch.block_mn + 1) // 2
            end_fail_gate[block_ends] = batch.block_is_cross.astype(np.float32)

            # pair threshold / is_self expanded to sub rows (pads: inf / self)
            thr_ns = np.full(ns, np.inf, dtype=np.float32)
            self_ns = np.ones(ns, dtype=bool)
            if ns_real:
                thr_ns[:ns_real] = batch.pair_threshold[sub_pair]
                self_ns[:ns_real] = batch.pair_meta[sub_pair, 5] == 1

            # bounded scan depths: longest block span / longest pair span
            counts_b = np.bincount(sub_block, minlength=nb)[:nb]
            max_block = max(1, int(counts_b.max(initial=1)))
            counts_p = np.bincount(sub_pair, minlength=np_real)[:np_real]
            max_pair = max(1, int(counts_p.max(initial=1)))

        d1 = max(1, int(np.ceil(np.log2(max_block))))
        d2 = max(2, int(np.ceil(np.log2(max_pair))))
        args = (
            batch.node_pos, muT, invT, winvT, pair_u, pair_v, sub_slot,
            flags_block, flags_pair, end_mn_inv, end_mn_half, end_fail_gate,
            thr_ns, self_ns,
        )
        return args, (d1, d2)

    def run_device(self, batch: ScreenBatch, prepared=None) -> torch.Tensor:
        """The "reference" engine: score_blocks_device on the screener's
        device. Returns the expanded [C, NS] table there."""
        if prepared is None:
            prepared = self.device_args(batch)
        args, (d1, d2) = prepared
        with self._device_scope():
            return score_blocks_device(
                *(self._to_device(a) for a in args), depth1=d1, depth2=d2
            )
