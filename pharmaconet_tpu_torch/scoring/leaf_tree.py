"""Prepack-baked leaf evaluation: the assignment search without a search.

The cluster-assignment DFS (scoring/tree.py, native/match_dfs.cpp) is the
last host-side stage of stored screening. This module removes it from the
screen-time path:

* The set of leaves the gated DFS VISITS depends on the pair-score table
  only through sign bits (conformer pruning on pair > 0) and the
  match-count gate (the None branch allowed when the best completable
  match count stays < 5). Tile stores pin the model AND the screening
  weights (tiled_store.model_fingerprint), so the visited leaf set is
  STATIC per store and is enumerated once at prepack time
  (native/match_dfs.cpp match_dfs_leaves; Python reference below).

* Each leaf's per-conformer score is a plain sum of table rows along its
  path (self rows of assigned clusters + cross rows of assigned pairs),
  valid while every cross row stays > 0. Screen time evaluates every
  baked leaf of a batch with one row gather and two batched products in
  torch (leaf2_scores_multi / leaf2_scores_device) behind the pair kernel,
  and the host tail collapses to reading [B] floats.

The numpy bake half is a copy of pharmaconet_tpu's (stores move between
the packages unchanged); the device half is torch. Its score product S
must run in full f32: the functions raise when TF32 matmuls are enabled.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MIN_MATCHES_FOR_SKIP = 5

# sentinel table rows appended on device: +0 = score 0 (padding / empty
# pairs: compact_pair_table scores them 0.0), +1 = score -1 (pruned pairs:
# host_prune_mask forces -1.0)
SENT_ZERO = 0
SENT_NEG = 1


# ==========================================================================
# Leaf enumeration (prepack time)
# ==========================================================================
def _ligand_offsets(n_active: int, cand_counts: np.ndarray):
    """(cross_off [n, n] i64 ligand-relative, self_off [n] i64, rows)."""
    self_off = np.zeros(n_active, dtype=np.int64)
    row = 0
    for l in range(n_active):
        self_off[l] = row
        row += int(cand_counts[l])
    cross_off = np.full((n_active, n_active), -1, dtype=np.int64)
    for i1 in range(n_active):
        for i2 in range(i1 + 1, n_active):
            cross_off[i1, i2] = row
            row += int(cand_counts[i1]) * int(cand_counts[i2])
    return cross_off, self_off, row


def _enumerate_python(batch, table: np.ndarray, lmax: int):
    """Reference Python port of match_dfs_leaves (same gated semantics)."""
    pair_starts, conformers, active_offsets, cand_counts = _dfs_arrays(batch)
    num = len(conformers)
    leaves: list[np.ndarray] = []
    offsets = np.zeros(num + 1, dtype=np.int64)
    for li in range(num):
        offsets[li] = len(leaves)
        a_lo, a_hi = int(active_offsets[li]), int(active_offsets[li + 1])
        n = a_hi - a_lo
        c = int(conformers[li])
        if n == 0 or c == 0:
            continue
        cc = cand_counts[a_lo:a_hi]
        cross_off, _self_off, rows = _ligand_offsets(n, cc)
        tl = table[int(pair_starts[li]) : int(pair_starts[li]) + rows, :c]
        pos = tl > 0  # [rows, c]
        assign = np.full(lmax, -1, dtype=np.int8)

        def rec(level, alive, num_matches):
            if level >= n:
                leaves.append(assign.copy())
                return 0
            max_matches = 0
            any_child = False
            for j in range(int(cc[level])):
                m = alive
                for k in range(level):
                    jk = assign[k]
                    if jk < 0:
                        continue
                    r = cross_off[k, level] + int(jk) * int(cc[level]) + j
                    m = m & pos[r]
                    if not m.any():
                        break
                if not m.any():
                    continue
                any_child = True
                assign[level] = j
                nm = rec(level + 1, m, num_matches + 1) + 1
                max_matches = max(max_matches, nm)
            if not any_child or num_matches + max_matches < MIN_MATCHES_FOR_SKIP:
                assign[level] = -1
                nm = rec(level + 1, alive, num_matches)
                max_matches = max(max_matches, nm)
            assign[level] = -1
            return max_matches

        rec(0, np.ones(c, dtype=bool), 0)
    offsets[num] = len(leaves)
    out = (
        np.stack(leaves).astype(np.int8)
        if leaves
        else np.zeros((0, lmax), np.int8)
    )
    return out, offsets


def _dfs_arrays(batch):
    """(pair_starts, conformers, active_offsets, cand_counts) for a
    ScreenBatch / TiledBatch / V3Batch / stored batch (duck-typed)."""
    cached = getattr(batch, "dfs_arrays", None)
    if cached is not None:
        return cached
    num = len(batch.ligand_clusters)
    pair_starts = np.array([s for s, _ in batch.pair_slices], dtype=np.int64)
    conformers = batch.num_conformers.astype(np.int32)[:num]
    active_offsets = [0]
    cand_counts: list[int] = []
    for active, cands in batch.candidates:
        cand_counts.extend(len(cands[l]) for l in active)
        active_offsets.append(len(cand_counts))
    return (
        pair_starts,
        np.ascontiguousarray(conformers),
        np.asarray(active_offsets, dtype=np.int32),
        np.asarray(cand_counts, dtype=np.int32)
        if cand_counts
        else np.zeros(0, np.int32),
    )


# |pair score| below this margin is treated as sign-unstable between the
# prepack backend and the screen-time device. A cross-pair score is either
# exactly -1.0 (fail-gated; the gate compares f32 ops on STORE-SHIPPED
# dt/mu/inv inputs, so it is reproducible) or a sum of positive gaussian
# terms — its sign can only flip where one backend flushes the subnormal/
# underflow tail to exact 0.0 and the other keeps a tiny positive value
# (a device that flushes subnormals against a CPU exp that keeps them).
# That region is bounded by
# ~mn_cap * f32_min_normal ~ 3e-36; 1e-30 covers it with 5 orders of
# margin while demoting essentially nothing (a 1e-5 margin demoted ~half
# the library: tiny positive gaussian tails are common and sign-SAFE).
SIGN_EPS = 1e-30


def near_zero_gate_flags(
    batch,
    table: np.ndarray,
    pair_end_rows: np.ndarray,
    prune: np.ndarray,
    eps: float = SIGN_EPS,
) -> np.ndarray:
    """[num] bool: the ligand has a gate-relevant (cross-pair, real kernel
    row, unpruned) cell with |value| < eps among its live conformers.

    Cross rows are the only values whose SIGN the DFS gates on (conformer
    pruning on pair > 0, reference tree.py:81). Compaction sentinels
    (empty pairs, exactly 0.0 on both host and device) and pruned rows
    (forced -1.0) are sign-exact by construction and excluded. Real rows
    computed as exact 0.0 (fully underflowed sums) ARE flagged — the
    other backend may keep a subnormal positive there. Residual exposure:
    a fail-count gate comparison landing within 1 ULP of its 4.0
    boundary under different fusion (FMA) choices — per-value measure
    zero, absorbed by the repo-standard score tolerance."""
    pair_starts, conformers, active_offsets, cand_counts = _dfs_arrays(batch)
    num = len(conformers)
    bounds = np.append(pair_starts, len(pair_end_rows)).astype(np.int64)
    flags = np.zeros(num, bool)
    for li in range(num):
        a_lo, a_hi = int(active_offsets[li]), int(active_offsets[li + 1])
        n_self = int(cand_counts[a_lo:a_hi].sum())
        lo = int(bounds[li]) + n_self
        hi = int(bounds[li + 1])
        c = int(conformers[li])
        if hi <= lo or c == 0:
            continue
        real = (pair_end_rows[lo:hi] >= 0) & ~prune[lo:hi]
        if not real.any():
            continue
        sub = table[lo:hi][real][:, :c]
        flags[li] = bool((np.abs(sub) < eps).any())
    return flags


def enumerate_leaves(batch, table: np.ndarray, native: bool = True):
    """(assign [NL, lmax] i8, leaf_offsets [B+1] i64) of the gated tree.

    `table` must be the FINAL host-semantics pair table: empty pairs 0.0,
    pruned pairs -1.0 (what _dfs_scores consumes). native=True runs
    native/match_dfs.cpp match_dfs_leaves (a failed build raises);
    native=False the Python reference above."""
    pair_starts, conformers, active_offsets, cand_counts = _dfs_arrays(batch)
    num = len(conformers)
    lmax = int(
        np.max(np.diff(active_offsets)) if num else 1
    )
    lmax = max(lmax, 1)
    if not native:
        return _enumerate_python(batch, table, lmax)
    from ..native import get_match_dfs_leaves

    fn = get_match_dfs_leaves()
    table_c = np.ascontiguousarray(table, dtype=np.float32)
    cap = max(64 * num, 1024)
    for _ in range(8):
        assign = np.empty((cap, lmax), dtype=np.int8)
        offsets = np.zeros(num + 1, dtype=np.int64)
        total = fn(
            num, table_c, table_c.shape[1],
            np.ascontiguousarray(pair_starts),
            np.ascontiguousarray(conformers),
            np.ascontiguousarray(active_offsets),
            np.ascontiguousarray(cand_counts)
            if len(cand_counts) else np.zeros(0, np.int32),
            lmax, cap, assign, offsets,
        )
        if total < 0:
            raise RuntimeError("match_dfs_leaves rejected the batch")
        if total <= cap:
            return assign[:total], offsets
        cap = int(total)
    raise RuntimeError("match_dfs_leaves capacity did not converge")

# ==========================================================================
# Dense window layout (prepack time)
# ==========================================================================
# Each ligand's pair rows are packed into a window of w_cap slots ([B, W,
# C] table via ONE row gather) and the leaf structure is baked as
# bit-packed one-hot matrices, so leaf evaluation is two batched matrix
# products. Heavy-tail ligands (leaves > l_cap or referenced pairs > w_cap,
# ~p97 caps) are demoted to the host DFS over a small device-gathered
# sub-table.
#
# Window slots hold only pairs REFERENCED by some leaf (a self row of an
# assigned cluster or a cross row of an assigned pair): leaves touch a
# small share of a ligand's pair rows, so referenced-only windows keep
# w_cap, and the row gather, small.


@dataclass
class DenseLeafBatch:
    """Device + host arrays for one batch's baked leaves (window layout).

    plane_score bit b of [B, L, W/8] marks window slot as summed into the
    leaf; plane_cross marks it as a cross pair (leaf dies if its value
    <= 0 — the tree's per-conformer pruning, reference tree.py:81).
    ends2 maps window slots to kernel row ids (NBT = appended zero row =
    empty pair -> 0.0, the host-compaction value). prune_w folds the
    static prune mask (-1.0) into the window on device."""

    plane_score: np.ndarray  # [B, L, W//8] u8
    plane_cross: np.ndarray  # [B, L, W//8] u8
    prune_w: np.ndarray  # [B, W] bool
    ends2: np.ndarray  # [B*W] i32 into [NBT]+zero-sentinel kernel rows
    out_live: np.ndarray  # [n_out] i32 live-ligand indices (DFS fallback)
    out_ends: np.ndarray  # [NOUT_pad] i32
    out_prune: np.ndarray  # [NOUT_pad] bool
    out_pair_starts: np.ndarray  # [n_out] i64 into the out table
    out_conformers: np.ndarray  # [n_out] i32
    out_active_offsets: np.ndarray  # [n_out+1] i32
    out_cand_counts: np.ndarray  # [sum active] i32
    n_out_rows: int  # real rows in out_ends (<= NOUT_pad)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _leaf_coords(a: np.ndarray, cc: np.ndarray):
    """(leaf_idx, row_idx, is_cross) flat bit coordinates of the rows the
    leaves in `a` [Lb, n] reference: the self row of every assigned
    cluster plus the cross row of every assigned pair."""
    leaves_b, n = a.shape
    cross_off, self_off, _ = _ligand_offsets(n, cc)
    assigned = a >= 0
    lidx = np.repeat(np.arange(leaves_b), n)
    srows = (self_off[None, :] + a).ravel()
    svalid = assigned.ravel()
    parts_l = [lidx[svalid]]
    parts_r = [srows[svalid]]
    parts_x = [np.zeros(int(svalid.sum()), bool)]
    iu, ju = np.triu_indices(n, k=1)
    if len(iu):
        xr = (
            cross_off[iu, ju][None, :]
            + a[:, iu] * cc[ju][None, :]
            + a[:, ju]
        ).ravel()
        xvalid = (assigned[:, iu] & assigned[:, ju]).ravel()
        lxid = np.repeat(np.arange(leaves_b), len(iu))
        parts_l.append(lxid[xvalid])
        parts_r.append(xr[xvalid])
        parts_x.append(np.ones(int(xvalid.sum()), bool))
    return (
        np.concatenate(parts_l),
        np.concatenate(parts_r),
        np.concatenate(parts_x),
    )


def leaf_window_stats(
    assign: np.ndarray,
    offsets: np.ndarray,
    active_offsets: np.ndarray,
    cand_counts: np.ndarray,
):
    """Per-ligand (n_referenced_rows, n_leaves) — the sizing inputs for
    the store-wide w_cap/l_cap choice (write_v3_store pass 2b)."""
    num = len(offsets) - 1
    nref = np.zeros(num, np.int64)
    leaves = np.diff(offsets).astype(np.int64)
    for li in range(num):
        lo, hi = int(offsets[li]), int(offsets[li + 1])
        if hi == lo:
            continue
        a_lo, a_hi = int(active_offsets[li]), int(active_offsets[li + 1])
        n = a_hi - a_lo
        cc = cand_counts[a_lo:a_hi].astype(np.int64)
        a = assign[lo:hi, :n].astype(np.int64)
        _, rows_l, _ = _leaf_coords(a, cc)
        nref[li] = len(np.unique(rows_l))
    return nref, leaves


def build_leaf_dense(
    assign: np.ndarray,
    offsets: np.ndarray,
    pair_starts: np.ndarray,
    conformers: np.ndarray,
    active_offsets: np.ndarray,
    cand_counts: np.ndarray,
    pair_end_rows: np.ndarray,
    prune: np.ndarray,
    l_cap: int,
    w_cap: int,
    nbt: int,
    batch_size: int,
    nout_pad: int | None = None,
    force_demote: np.ndarray | None = None,
) -> DenseLeafBatch:
    """Bake the enumerated leaves into the dense window layout.

    All shape params are store-wide statics; a ligand whose leaf count or
    leaf-referenced row count exceeds the caps joins the outlier (host
    DFS) set. Window slot j of a ligand holds its j-th REFERENCED pair
    row (sorted ligand-relative order) — rows no leaf touches get no
    slot, which halves w_cap on the bench pool.

    force_demote [num] bool sends a ligand to the outlier set regardless
    of caps — used for ligands whose gate-relevant pair scores sit within
    epsilon of zero, where prepack-host vs screen-device f32 rounding
    could flip a sign bit and change the visited leaf set (the outlier
    DFS reruns the search on screen-time values, so it is always exact)."""
    num = len(conformers)
    w8 = w_cap // 8
    assert w_cap % 8 == 0
    plane_s = np.zeros((batch_size, l_cap, w_cap), bool)
    plane_c = np.zeros((batch_size, l_cap, w_cap), bool)
    prune_w = np.zeros((batch_size, w_cap), bool)
    ends2 = np.full(batch_size * w_cap, nbt, np.int32)
    np_total = len(pair_end_rows)
    row_of = np.where(pair_end_rows >= 0, pair_end_rows, nbt).astype(np.int32)
    bounds = np.append(pair_starts, np_total).astype(np.int64)

    out_live: list[int] = []
    out_rows_list: list[np.ndarray] = []
    out_prune_list: list[np.ndarray] = []
    out_ps: list[int] = []
    out_conf: list[int] = []
    out_ao: list[int] = [0]
    out_cc: list[np.ndarray] = []
    out_at = 0

    for li in range(num):
        ps, pe = int(bounds[li]), int(bounds[li + 1])
        rows_b = pe - ps
        lo, hi = int(offsets[li]), int(offsets[li + 1])
        leaves_b = hi - lo
        a_lo, a_hi = int(active_offsets[li]), int(active_offsets[li + 1])

        def demote() -> None:
            out_live.append(li)
            out_rows_list.append(row_of[ps:pe])
            out_prune_list.append(prune[ps:pe])
            out_ps.append(out_at)
            out_conf.append(int(conformers[li]))
            out_cc.append(cand_counts[a_lo:a_hi])
            out_ao.append(out_ao[-1] + (a_hi - a_lo))

        if leaves_b > l_cap or (
            force_demote is not None and force_demote[li]
        ):
            demote()
            out_at += rows_b
            continue
        if leaves_b == 0:
            # no leaves -> score 0 with an all-sentinel (empty) window
            continue
        n = a_hi - a_lo
        cc = cand_counts[a_lo:a_hi].astype(np.int64)
        a = assign[lo:hi, :n].astype(np.int64)  # [Lb, n]
        lidx, rows_l, is_x = _leaf_coords(a, cc)
        ref = np.unique(rows_l)  # referenced ligand-relative rows, sorted
        if len(ref) > w_cap:
            demote()
            out_at += rows_b
            continue
        ends2[li * w_cap : li * w_cap + len(ref)] = row_of[ps + ref]
        prune_w[li, : len(ref)] = prune[ps + ref]
        slot = np.searchsorted(ref, rows_l)
        plane_s[li, lidx, slot] = True
        plane_c[li, lidx[is_x], slot[is_x]] = True

    n_out_rows = out_at
    nout = nout_pad if nout_pad is not None else max(_round_up(out_at, 8), 8)
    if out_at > nout:
        raise ValueError(f"outlier rows {out_at} exceed nout_pad {nout}")
    out_ends = np.full(nout, nbt, np.int32)
    out_pr = np.zeros(nout, bool)
    if out_rows_list:
        out_ends[:out_at] = np.concatenate(out_rows_list)
        out_pr[:out_at] = np.concatenate(out_prune_list)
    return DenseLeafBatch(
        plane_score=np.packbits(plane_s, axis=2),
        plane_cross=np.packbits(plane_c, axis=2),
        prune_w=prune_w,
        ends2=ends2,
        out_live=np.asarray(out_live, np.int32),
        out_ends=out_ends,
        out_prune=out_pr,
        out_pair_starts=np.asarray(out_ps, np.int64),
        out_conformers=np.asarray(out_conf, np.int32),
        out_active_offsets=np.asarray(out_ao, np.int32),
        out_cand_counts=(
            np.concatenate(out_cc).astype(np.int32)
            if out_cc else np.zeros(0, np.int32)
        ),
        n_out_rows=n_out_rows,
    )


# ==========================================================================
# Bucketed window layout (prepack time)
# ==========================================================================
# The single-cap window layout gathers B x W_cap slots even though the
# median ligand references far fewer rows than the p97 cap. Bucketing
# ligands by their referenced-row
# count into store-derived width classes (multiples of 64) shrinks the
# gathered slot count to ~E[ceil(nref/64)*64] per ligand — the windows
# and one-hot planes of narrow ligands stop paying for the wide tail.
# Each bucket k holds Bk ligands (store-wide capacity) with caps
# (Lk, Wk); evaluation is the same two batched products per bucket,
# with a final scatter back to batch order. Outlier (host DFS) handling
# is shared with the single layout.


@dataclass
class DenseLeafBucket:
    """One width class of a bucketed leaf bake (arrays padded to Bk)."""

    lig_idx: np.ndarray  # [Bk] i32 live-ligand index; pad = batch_size
    conf: np.ndarray  # [Bk] i32 conformer counts (1 for pads)
    plane_score: np.ndarray  # [Bk, Lk, Wk//8] u8
    plane_cross: np.ndarray  # [Bk, Lk, Wk//8] u8
    prune_w: np.ndarray  # [Bk, Wk] bool
    ends2: np.ndarray  # [Bk*Wk] i32 into [NBT]+zero-sentinel kernel rows


@dataclass
class LeafBake:
    """Bucketed bake of one batch: width-class buckets + the shared
    outlier (host DFS) arrays — same semantics as DenseLeafBatch's."""

    buckets: list[DenseLeafBucket]
    out_live: np.ndarray
    out_ends: np.ndarray
    out_prune: np.ndarray
    out_pair_starts: np.ndarray
    out_conformers: np.ndarray
    out_active_offsets: np.ndarray
    out_cand_counts: np.ndarray
    n_out_rows: int


def choose_bucket_edges(
    nref_baked: np.ndarray, granule: int = 64, max_buckets: int = 4
) -> list[int]:
    """Store-wide window width classes from the baked-ligand referenced-
    row distribution: quantile edges rounded up to `granule`, deduplicated
    ascending, last edge covering the maximum."""
    sel = nref_baked[nref_baked > 0]
    if len(sel) == 0:
        return [granule]
    qs = (0.5, 0.8, 0.95, 1.0)[-max_buckets:]
    rnd = lambda v: int(((max(int(v), 1) + granule - 1) // granule) * granule)  # noqa: E731
    edges = sorted({rnd(np.quantile(sel, q)) for q in qs})
    if edges[-1] < rnd(sel.max()):
        edges[-1] = rnd(sel.max())
    return edges


def build_leaf_buckets(
    assign: np.ndarray,
    offsets: np.ndarray,
    pair_starts: np.ndarray,
    conformers: np.ndarray,
    active_offsets: np.ndarray,
    cand_counts: np.ndarray,
    pair_end_rows: np.ndarray,
    prune: np.ndarray,
    bucket_specs: list[tuple[int, int, int]],  # (Bk, Lk, Wk) store-wide
    nbt: int,
    batch_size: int,
    nout_pad: int | None = None,
    force_demote: np.ndarray | None = None,
) -> LeafBake:
    """Bake one batch's enumerated leaves into width-class buckets.

    A ligand lands in the narrowest bucket whose (Lk, Wk) covers its
    (leaves, referenced rows); force_demote or no fitting bucket sends it
    to the outlier host-DFS set; zero-leaf ligands stay out of every
    bucket (score 0 by construction). Raises if a bucket overflows its
    store-wide Bk capacity (the writer sizes capacities from the same
    stats, so this is a programming error, not data)."""
    num = len(conformers)
    np_total = len(pair_end_rows)
    row_of = np.where(pair_end_rows >= 0, pair_end_rows, nbt).astype(np.int32)
    bounds = np.append(pair_starts, np_total).astype(np.int64)

    buckets = [
        DenseLeafBucket(
            lig_idx=np.full(bk, batch_size, np.int32),
            conf=np.ones(bk, np.int32),
            plane_score=np.zeros((bk, lk, wk), bool),
            plane_cross=np.zeros((bk, lk, wk), bool),
            prune_w=np.zeros((bk, wk), bool),
            ends2=np.full(bk * wk, nbt, np.int32),
        )
        for bk, lk, wk in bucket_specs
    ]
    fill = [0] * len(bucket_specs)

    out_live: list[int] = []
    out_rows_list: list[np.ndarray] = []
    out_prune_list: list[np.ndarray] = []
    out_ps: list[int] = []
    out_conf: list[int] = []
    out_ao: list[int] = [0]
    out_cc: list[np.ndarray] = []
    out_at = 0

    for li in range(num):
        ps, pe = int(bounds[li]), int(bounds[li + 1])
        rows_b = pe - ps
        lo, hi = int(offsets[li]), int(offsets[li + 1])
        leaves_b = hi - lo
        a_lo, a_hi = int(active_offsets[li]), int(active_offsets[li + 1])

        def demote() -> None:
            out_live.append(li)
            out_rows_list.append(row_of[ps:pe])
            out_prune_list.append(prune[ps:pe])
            out_ps.append(out_at)
            out_conf.append(int(conformers[li]))
            out_cc.append(cand_counts[a_lo:a_hi])
            out_ao.append(out_ao[-1] + (a_hi - a_lo))

        if force_demote is not None and force_demote[li]:
            demote()
            out_at += rows_b
            continue
        if leaves_b == 0:
            continue
        n = a_hi - a_lo
        cc = cand_counts[a_lo:a_hi].astype(np.int64)
        a = assign[lo:hi, :n].astype(np.int64)
        lidx, rows_l, is_x = _leaf_coords(a, cc)
        ref = np.unique(rows_l)
        k = next(
            (
                j
                for j, (_bk, lk, wk) in enumerate(bucket_specs)
                if leaves_b <= lk and len(ref) <= wk
            ),
            None,
        )
        if k is None:
            demote()
            out_at += rows_b
            continue
        b = buckets[k]
        at = fill[k]
        if at >= bucket_specs[k][0]:
            raise ValueError(
                f"bucket {k} overflow: capacity {bucket_specs[k][0]}"
            )
        fill[k] = at + 1
        wk = bucket_specs[k][2]
        b.lig_idx[at] = li
        b.conf[at] = max(int(conformers[li]), 1)
        b.ends2[at * wk : at * wk + len(ref)] = row_of[ps + ref]
        b.prune_w[at, : len(ref)] = prune[ps + ref]
        slot = np.searchsorted(ref, rows_l)
        b.plane_score[at, lidx, slot] = True
        b.plane_cross[at, lidx[is_x], slot[is_x]] = True

    for b in buckets:
        b.plane_score = np.packbits(b.plane_score, axis=2)
        b.plane_cross = np.packbits(b.plane_cross, axis=2)

    n_out_rows = out_at
    nout = nout_pad if nout_pad is not None else max(_round_up(out_at, 8), 8)
    if out_at > nout:
        raise ValueError(f"outlier rows {out_at} exceed nout_pad {nout}")
    out_ends = np.full(nout, nbt, np.int32)
    out_pr = np.zeros(nout, bool)
    if out_rows_list:
        out_ends[:out_at] = np.concatenate(out_rows_list)
        out_pr[:out_at] = np.concatenate(out_prune_list)
    return LeafBake(
        buckets=buckets,
        out_live=np.asarray(out_live, np.int32),
        out_ends=out_ends,
        out_prune=out_pr,
        out_pair_starts=np.asarray(out_ps, np.int64),
        out_conformers=np.asarray(out_conf, np.int32),
        out_active_offsets=np.asarray(out_ao, np.int32),
        out_cand_counts=(
            np.concatenate(out_cc).astype(np.int32)
            if out_cc else np.zeros(0, np.int32)
        ),
        n_out_rows=n_out_rows,
    )


# ==========================================================================
# Device evaluation (screen time, torch)
# ==========================================================================
def _require_f32_matmul() -> None:
    """S sums pair scores through a matrix product; a TF32 product keeps
    ~3 decimal digits and moves scores far outside the repo tolerance."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "leaf evaluation needs full-f32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


def _unpack_bits(plane: torch.Tensor, count: int) -> torch.Tensor:
    """np.unpackbits(plane, axis=-1, count=count) for a u8 tensor (bits
    big-endian within a byte, numpy's order), as f32 0/1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=plane.device)
    bits = (plane.unsqueeze(-1) >> shifts) & 1  # [..., W/8, 8]
    return bits.reshape(*plane.shape[:-1], -1)[..., :count].to(torch.float32)


def _window(rows_z: torch.Tensor, ends2: torch.Tensor, prune_w: torch.Tensor) -> torch.Tensor:
    """[B, W, C] window values: the kernel rows at ends2 (the appended zero
    row for empty slots), -1 on pruned pairs."""
    b, w = prune_w.shape
    tw = rows_z.index_select(0, ends2.long()).reshape(b, w, rows_z.shape[1])
    return torch.where(prune_w[:, :, None], -1.0, tw)


def _in_range_or(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx as int64 with every index outside [0, n) sent to n: writes go
    to one spare slot past the end, which the caller drops (no host sync,
    unlike a boolean mask)."""
    idx = idx.long()
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _scatter_ones(idx: torch.Tensor, size: int) -> torch.Tensor:
    """[size] f32 with 1 at idx; indices outside [0, size) (the wire's pad
    value `size`) are dropped."""
    out = torch.zeros(size + 1, dtype=torch.float32, device=idx.device)
    return out.index_fill_(0, _in_range_or(idx, size), 1.0)[:size]


def _bucket_epilogue(s: torch.Tensor, a_c: torch.Tensor, tw: torch.Tensor,
                     conf: torch.Tensor) -> torch.Tensor:
    """[B] scores from the leaf sums S [B, L, C]: a leaf dies where one of
    its cross values is <= 0 (count D, an exact f32 product of 0/1
    operands); the best live leaf (floored at 0) per conformer, averaged
    over the ligand's conformers."""
    c = tw.shape[2]
    d = torch.bmm(a_c, (tw <= 0.0).to(torch.float32))
    leaf_val = torch.where(d > 0.5, -torch.inf, s)
    best = leaf_val.max(dim=1).values.clamp_min(0.0)  # [B, C]
    conf_ok = torch.arange(c, device=tw.device)[None, :] < conf[:, None]
    denom = conf.clamp_min(1).to(tw.dtype)
    return torch.where(conf_ok, best, 0.0).sum(dim=1) / denom


def leaf2_scores_device(
    rows: torch.Tensor,  # [NBT, C] f32 raw kernel output (score_tiles_v3_rows)
    ends2: torch.Tensor,  # [B*W] i32
    plane_s: torch.Tensor,  # [B, L, W//8] u8
    plane_c: torch.Tensor,  # [B, L, W//8] u8
    prune_w: torch.Tensor,  # [B, W] bool
    conformers: torch.Tensor,  # [B] i32
    out_ends: torch.Tensor,  # [NOUT_pad] i32
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B] scores, [NOUT_pad, C] outlier pair rows) for the single-window
    leaf layout (build_leaf_dense): one bucket's evaluation over the whole
    batch. The counterpart of the JAX leaf2_scores_device."""
    _require_f32_matmul()
    rows_z = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    scores = _bucket_scores(rows_z, ends2, plane_s, plane_c, prune_w, conformers)
    return scores, rows_z.index_select(0, out_ends.long())


def _bucket_scores(rows_z, ends2, plane_s, plane_c, prune_w, conf) -> torch.Tensor:
    """[Bk] leaf scores of one dense-wire bucket at its (Lk, Wk):
    S[b,l,c] = sum of the leaf's selected window values, D[b,l,c] = count
    of its non-positive cross values (> 0 kills the leaf)."""
    wk = prune_w.shape[1]
    tw = _window(rows_z, ends2, prune_w)
    s = torch.bmm(_unpack_bits(plane_s, wk), tw)
    return _bucket_epilogue(s, _unpack_bits(plane_c, wk), tw, conf)


def _bucket_scores_sparse(rows_z, ends2, sidx, cidx, prune_w, conf, shp) -> torch.Tensor:
    """[Bk] leaf scores of one sparse-wire bucket: the set-bit flat
    indices (i32 into [Bk, Lk, Wk], pad = size, dropped) rebuild the same
    one-hot planes with one scatter each, feeding the same products.
    `shp` is a [Lk, 0] placeholder whose shape carries the leaf cap."""
    bk, wk = prune_w.shape
    lk = shp.shape[0]
    size = bk * lk * wk
    check_sparse_size(size)
    tw = _window(rows_z, ends2, prune_w)
    a_s = _scatter_ones(sidx, size).reshape(bk, lk, wk)
    a_c = _scatter_ones(cidx, size).reshape(bk, lk, wk)
    return _bucket_epilogue(torch.bmm(a_s, tw), a_c, tw, conf)


def leaf2_scores_multi(
    rows: torch.Tensor,  # [NBT, C] f32 raw kernel output
    out_ends: torch.Tensor,  # [NOUT_pad] i32
    buckets: tuple,  # K x (ends2, plane_s, plane_c, prune_w, conf, lig_idx) or sparse 7-tuples
    nb: int,  # batch_size (scatter target length)
) -> tuple[torch.Tensor, torch.Tensor]:
    """([nb] scores, [NOUT_pad, C] outlier rows) over width-class buckets.

    Per bucket: one window gather and two batched products at the
    bucket's (Lk, Wk); scores scatter back to batch order (lig_idx
    outside [0, nb), the pad value nb, is dropped). Ligands in no bucket
    (zero leaves / outliers) stay 0. The counterpart of the JAX
    leaf2_scores_multi."""
    _require_f32_matmul()
    rows_z = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    scores = rows.new_zeros(nb + 1)  # slot nb takes the dropped pads
    for b in buckets:
        if len(b) == 7:  # sparse wire: (ends2, sidx, cidx, pw, conf, idx, shp)
            ends2, sidx, cidx, prune_w, conf, lig_idx, shp = b
            sk = _bucket_scores_sparse(rows_z, ends2, sidx, cidx, prune_w, conf, shp)
        else:
            ends2, plane_s, plane_c, prune_w, conf, lig_idx = b
            sk = _bucket_scores(rows_z, ends2, plane_s, plane_c, prune_w, conf)
        scores.index_copy_(0, _in_range_or(lig_idx, nb), sk)
    return scores[:nb], rows_z.index_select(0, out_ends.long())


# ==========================================================================
# Host helpers (sparse wire, f64 mirrors)
# ==========================================================================
def planes_to_sparse(plane_u8: np.ndarray, wk: int) -> np.ndarray:
    """Set-bit flat indices (i32, C-order over [Bk, Lk, Wk]) of a packed
    bit-plane — the sparse wire form consumed by _bucket_scores_sparse.
    The wire pads with the plane size, so that size must fit int32 too."""
    check_sparse_size(plane_u8.shape[0] * plane_u8.shape[1] * wk)
    bits = np.unpackbits(plane_u8, axis=2, count=wk)
    return np.flatnonzero(bits).astype(np.int32)


def check_sparse_size(size: int) -> None:
    """The sparse wire's pad sentinel is the plane size bk*lk*wk, stored
    as int32: it must stay below 2**31."""
    if size >= 2**31:
        raise ValueError(
            f"sparse leaf plane of {size} entries: bk*lk*wk must be < 2**31 "
            "for the int32 pad sentinel"
        )


def store_bucket_planes(b: tuple) -> tuple:
    """Normalize a TiledStore leaf-bucket tuple to the dense 6-tuple
    (ends2, plane_score_u8, plane_cross_u8, prune_w, conf, lig_idx).

    Sparse-wire tuples (arity 7: set-bit flat indices + a [Lk, 0] shape
    placeholder) are densified on host, so the f64 mirror runs
    identically for either wire."""
    if len(b) == 6:
        return tuple(np.asarray(a) for a in b)
    ends2, sidx, cidx, prune_w, conf, lig_idx, shp = (np.asarray(a) for a in b)
    bk, wk = prune_w.shape
    lk = shp.shape[0]
    size = bk * lk * wk
    planes = []
    for idx in (sidx, cidx):
        flat = np.zeros(size, np.uint8)
        flat[idx[idx < size]] = 1
        planes.append(np.packbits(flat.reshape(bk, lk, wk), axis=2))
    return ends2, planes[0], planes[1], prune_w, conf, lig_idx


def leaf2_scores_host(
    rows: np.ndarray, lb: DenseLeafBatch, conformers: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Numpy f64 mirror of leaf2_scores_device (tests)."""
    c = rows.shape[1]
    b, w = lb.prune_w.shape
    rows_z = np.concatenate([rows, np.zeros((1, c), rows.dtype)])
    tw = rows_z[lb.ends2].reshape(b, w, c).astype(np.float64)
    tw[lb.prune_w] = -1.0
    a_s = np.unpackbits(lb.plane_score, axis=2, count=w)
    a_c = np.unpackbits(lb.plane_cross, axis=2, count=w)
    s = np.einsum("blw,bwc->blc", a_s.astype(np.float64), tw)
    d = np.einsum("blw,bwc->blc", a_c.astype(np.float64), tw <= 0.0)
    leaf_val = np.where(d > 0.5, -np.inf, s)
    best = np.maximum(leaf_val.max(axis=1), 0.0)
    conf_ok = np.arange(c)[None, :] < conformers[:, None]
    denom = np.maximum(conformers, 1).astype(np.float64)
    scores = np.where(conf_ok, best, 0.0).sum(axis=1) / denom
    return scores, rows_z[lb.out_ends]


def leaf2_scores_multi_host(
    rows: np.ndarray, bake: LeafBake, nb: int
) -> tuple[np.ndarray, np.ndarray]:
    """Numpy f64 mirror of leaf2_scores_multi (tests)."""
    c = rows.shape[1]
    rows_z = np.concatenate([rows, np.zeros((1, c), rows.dtype)])
    scores = np.zeros(nb, np.float64)
    for b in bake.buckets:
        bk, wk = b.prune_w.shape
        tw = rows_z[b.ends2].reshape(bk, wk, c).astype(np.float64)
        tw[b.prune_w] = -1.0
        a_s = np.unpackbits(b.plane_score, axis=2, count=wk)
        a_c = np.unpackbits(b.plane_cross, axis=2, count=wk)
        s = np.einsum("blw,bwc->blc", a_s.astype(np.float64), tw)
        d = np.einsum("blw,bwc->blc", a_c.astype(np.float64), tw <= 0.0)
        leaf_val = np.where(d > 0.5, -np.inf, s)
        best = np.maximum(leaf_val.max(axis=1), 0.0)
        conf_ok = np.arange(c)[None, :] < b.conf[:, None]
        denom = np.maximum(b.conf, 1).astype(np.float64)
        sk = np.where(conf_ok, best, 0.0).sum(axis=1) / denom
        live = b.lig_idx < nb
        scores[b.lig_idx[live]] = sk[live]
    return scores, rows_z[bake.out_ends]
