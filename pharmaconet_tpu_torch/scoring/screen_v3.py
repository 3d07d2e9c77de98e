"""v3 screening layout: block-major rows + deduplicated group tables.

The v2 tile layout (screen_tiles.py / tiled_pack.py) streams the Gaussian
parameters (mu, 1/std, w/std) expanded PER ROW, ~98 KB per tile. Those
parameters are a pure function of the block's "group": the (model cluster
pair, ligand-node type pair) combination, and a batch holds only a few
hundred distinct groups. v3 stops re-streaming them:

  * one row per BLOCK (ligand node pair), not per 8-slot sub-chunk; the
    model-node-pair (mn) axis moves inside the kernel
  * per-block Gaussian tables are content-deduplicated into GROUPS; each
    tile carries a small [G_CAP, R] table of the groups it uses and a
    per-row group-slot id, which K2 (ops/screen_cuda.score_tiles_v3_rows)
    reads with an indexed load from shared memory
  * rows are sorted by (group of first block, pair) so tiles reference
    few distinct groups; tiles pad to the boundary when a pair would
    straddle it (scan segments never cross tiles) or when the group
    budget would overflow
  * the block-level fail logic (((dt-mu)/std)^2 < 4 counting vs
    (MN+1)//2) happens in-row, so only ONE bounded segmented scan remains
    (pair level), at a smaller depth (max blocks/pair)

Per-tile streams: dt [c,tile] + gid [1,tile] i32 + tab [G_CAP, R_pad] +
aux [3,tile] + out.

Score semantics are unchanged (same math as match_kernels.py); the block
normalization 1/(M*N) and 1/std are folded into the per-entry weight
w2 = w/std/mn at build time (one extra f32 rounding per term, inside the
repo-standard rtol 2e-5 / atol 1e-4 score tolerance). The arrays are
element-equal to pharmaconet_tpu's screen_v3 on the same batch, so stores
move between the packages unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .screen_tiles import TILE

V3_G_CAP = 16  # group-table slots per tile (raise per-batch if one pair
# references more groups; build_v3_layout auto-grows to the next power of 2)


@dataclass
class V3Batch:
    """Device arrays + host metadata for the v3 kernel.

    Host-side fields mirror ScreenBatch/TiledBatch so host_prune_mask and
    _dfs_scores consume a V3Batch unchanged (duck typing)."""

    # device inputs
    dt: np.ndarray  # [T, cmax, tile] f32 conformer distances per block row
    gid: np.ndarray  # [T, tile] i32 group slot within the tile table
    tab: np.ndarray  # [T, G_CAP, R_pad] f32 group tables (lane-major R)
    aux: np.ndarray  # [T, 3, tile] f32 (pair-start flag, thr, is_self)
    depth: int  # pair-level scan depth (2^depth >= max blocks/pair)
    mn_cap: int
    g_cap: int
    nbt: int  # real rows (<= T * tile)
    # host metadata (compact / prune / DFS)
    pair_end_rows: np.ndarray  # [NP] i64 (-1 for empty pairs)
    pair_threshold: np.ndarray
    pair_meta: np.ndarray
    pair_slices: list
    candidates: list
    ligand_clusters: list
    num_conformers: np.ndarray
    lig_cluster_center: np.ndarray
    lig_cluster_size: np.ndarray
    ln: int
    cmax: int
    # [NPpad] i32 pair-end rows clipped >= 0, padded to a shape bucket —
    # input of the on-device pair-compaction program (score_tiles_v3_pairs);
    # None means the caller compacts on host from pair_end_rows
    ends_padded: np.ndarray | None = None


def padded_ends(pair_end_rows: np.ndarray, np_pad: int) -> np.ndarray:
    """Clip (-1 -> 0) and zero-pad pair-end rows to `np_pad` for the
    device gather; the host re-masks empty pairs from the signed copy."""
    ends = np.clip(pair_end_rows, 0, None).astype(np.int32)
    if np_pad < len(ends):
        raise ValueError(f"np_pad {np_pad} < NP {len(ends)}")
    return np.pad(ends, (0, np_pad - len(ends)))


AUX3_FP, AUX3_THR, AUX3_SELF = range(3)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _block_offsets(batch):
    """(mn [NB] i64, first_row [NB] i64): block sizes + each block's first
    sub-row. Emission appends a block's sub rows contiguously
    (batch_screen.py emit_block); the native packer is element-equality-
    tested against it."""
    nb = len(batch.block_mn)
    rows_per_block = np.bincount(batch.sub_block, minlength=nb)
    first_row = np.zeros(nb, dtype=np.int64)
    np.cumsum(rows_per_block[:-1], out=first_row[1:])
    assert np.all(np.diff(batch.sub_block) >= 0), "sub_block not monotone"
    return batch.block_mn.astype(np.int64), first_row


def _expand_rows(batch, idx, mn, first_row, mn_cap):
    """(mu, std, w) [len(idx), mn_cap] gaussian tables for the blocks in
    `idx`. Padding entries: mu 0, std 1, w 0 (w == 0 marks invalid slots,
    the same convention as the v2 winv tables)."""
    p = batch.sub_mu.shape[1]
    k = np.arange(mn_cap)
    valid = k[None, :] < mn[idx, None]
    # clamped reads are masked out by `valid` (np.where evaluates both arms)
    row_idx = np.minimum(first_row[idx, None] + k[None, :] // p,
                         len(batch.sub_mu) - 1)
    slot = np.broadcast_to(k[None, :] % p, row_idx.shape)
    mu_b = np.where(valid, batch.sub_mu[row_idx, slot], 0.0).astype(np.float32)
    std_b = np.where(valid, batch.sub_std[row_idx, slot], 1.0).astype(np.float32)
    w_b = np.where(valid, batch.sub_w[row_idx, slot], 0.0).astype(np.float32)
    return mu_b, std_b, w_b


def block_tables(batch, mn_cap: int | None = None):
    """Per-block gaussian tables gathered from the sub-row arrays.

    Returns (mu_b, std_b, w_b [NB, mn_cap], mn [NB], first_row [NB],
    mn_cap)."""
    mn, first_row = _block_offsets(batch)
    mn_cap = mn_cap or _round_up(max(int(mn.max(initial=1)), 1), 8)
    if mn.max(initial=0) > mn_cap:
        raise ValueError(f"mn {mn.max()} exceeds mn_cap {mn_cap}")
    idx = np.arange(len(mn))
    mu_b, std_b, w_b = _expand_rows(batch, idx, mn, first_row, mn_cap)
    return mu_b, std_b, w_b, mn, first_row, mn_cap


def group_ids_meta(batch, model, mn, first_row, mn_cap, sample: int = 512):
    """Exact group ids from metadata, without expanding [NB, R] tables.

    A block's gaussian rows are emitted (batch_screen.py emit_block) from
    the (p, q) sequence a_nodes x b_nodes, where a_nodes = the model nodes
    of cluster m1 whose type bit is set in ligand node u's mask (in type-bit
    order, batch_screen.py matched()) and b_nodes likewise from (v, m2).
    mu/std/w are pure model-table lookups of (p, q). So the block's content
    is exactly determined by the integer tuple

        (node_mask[u] & avail[m1], m1, node_mask[v] & avail[m2], m2)

    with avail[m] = the OR of type bits m has candidate nodes for (masked
    bits with no nodes contribute nothing to a_nodes). Deduplicating on
    this packed int64 key replaces the [NB, 3*mn_cap+1] float signature
    hash of group_blocks, the hot phase of the v3 prepack, with [NB]
    integer ops.

    Returns (gid_of_block [NB] i64, group_sig [G, 3*mn_cap+1]) like
    group_blocks, or None when the batch carries no node_mask metadata or
    a sampled exact-content check fails (callers then fall back to the
    content-hash path).

    `sample` blocks are verified by expanding their rows and comparing to
    their representative's — an exact guard for the derivation above
    against future emit changes."""
    node_mask = getattr(batch, "node_mask", None)
    if node_mask is None or model is None:
        return None
    nb = len(mn)
    ln = batch.ln
    d_idx = batch.sub_d_idx[first_row].astype(np.int64)
    li = d_idx // (ln * ln)
    rem = d_idx % (ln * ln)
    u = rem // ln
    v = rem % ln
    m1 = batch.pair_meta[batch.block_pair, 3].astype(np.int64)
    m2 = batch.pair_meta[batch.block_pair, 4].astype(np.int64)
    avail = np.asarray(
        [
            sum(1 << t for t, nodes in enumerate(per_cluster) if nodes)
            for per_cluster in model.cluster_type_nodes
        ],
        dtype=np.int64,
    )
    n_clusters = len(avail)
    if n_clusters >= (1 << 16) or int(node_mask.max(initial=0)) >= (1 << 8):
        return None  # key packing would overflow; use the content hash
    eff_u = node_mask[li, u].astype(np.int64) & avail[m1]
    eff_v = node_mask[li, v].astype(np.int64) & avail[m2]
    key = (eff_u << 40) | (m1 << 24) | (eff_v << 16) | m2
    _, first_idx, gid_of_block = np.unique(
        key, return_index=True, return_inverse=True
    )
    gid_of_block = gid_of_block.astype(np.int64).ravel()
    rep_idx = first_idx.astype(np.int64)

    # representative tables ([G, mn_cap] instead of [NB, mn_cap])
    mu_g, std_g, w_g = _expand_rows(batch, rep_idx, mn, first_row, mn_cap)
    group_sig = np.empty((len(rep_idx), 3 * mn_cap + 1), dtype=np.float32)
    group_sig[:, :mn_cap] = mu_g
    group_sig[:, mn_cap : 2 * mn_cap] = std_g
    group_sig[:, 2 * mn_cap : 3 * mn_cap] = w_g
    group_sig[:, 3 * mn_cap] = mn[rep_idx]

    # distinct keys can share content (e.g. non-edge blocks all carry
    # mu=0/std=1 and type-level weights): exact-dedup the representative
    # signatures (a few hundred rows — trivial) so the partition equals
    # the content-hash one and g_cap pressure doesn't grow
    sig_view = np.ascontiguousarray(group_sig).view(
        np.dtype((np.void, group_sig.shape[1] * 4))
    ).ravel()
    _, keep, merge = np.unique(sig_view, return_index=True, return_inverse=True)
    if len(keep) < len(rep_idx):
        group_sig = group_sig[keep]
        mu_g, std_g, w_g = mu_g[keep], std_g[keep], w_g[keep]
        rep_idx = rep_idx[keep]
        gid_of_block = merge.astype(np.int64).ravel()[gid_of_block]

    # sampled exact-content verification
    s = min(nb, sample)
    pick = np.random.default_rng(0xC0FFEE).choice(nb, size=s, replace=False)
    mu_s, std_s, w_s = _expand_rows(batch, pick, mn, first_row, mn_cap)
    g = gid_of_block[pick]
    ok = (
        np.array_equal(mu_s, mu_g[g])
        and np.array_equal(std_s, std_g[g])
        and np.array_equal(w_s, w_g[g])
        and np.array_equal(mn[pick], mn[rep_idx][g])
    )
    if not ok:  # pragma: no cover - guards future emit-order changes
        import logging

        logging.getLogger(__name__).warning(
            "v3 metadata group keys disagree with block content on a "
            "sample; falling back to content-hash grouping"
        )
        return None
    return gid_of_block, group_sig


def group_blocks(mu_b, std_b, w_b, mn):
    """Content-deduplicate per-block tables into groups.

    Returns (gid_of_block [NB] i64, group_sig [G, 3*mn_cap+1] f32) where
    a signature row is (mu..., std..., w..., mn).

    Dedup runs on 64-bit row hashes (an exact byte sort of ~200-byte rows
    costs ~10 s/batch); a vectorized exact verification compares every row
    against its group representative afterwards, falling back to the exact
    sort in the (astronomically unlikely) event of a hash collision."""
    nb, mn_cap = mu_b.shape
    sig = np.empty((nb, 3 * mn_cap + 1), dtype=np.float32)
    sig[:, :mn_cap] = mu_b
    sig[:, mn_cap : 2 * mn_cap] = std_b
    sig[:, 2 * mn_cap : 3 * mn_cap] = w_b
    sig[:, 3 * mn_cap] = mn
    sig = np.ascontiguousarray(sig)

    words = sig.view(np.uint32).astype(np.uint64)  # [NB, R]
    rng = np.random.default_rng(0x5EED)
    mult = rng.integers(1, 2**63, size=words.shape[1], dtype=np.uint64) * 2 + 1
    h = (words * mult[None, :]).sum(axis=1)  # wraps mod 2^64
    uniq_h, first_idx, gid_of_block = np.unique(
        h, return_index=True, return_inverse=True
    )
    gid_of_block = gid_of_block.astype(np.int64).ravel()
    rep = sig[first_idx]
    if not np.array_equal(rep[gid_of_block], sig):  # hash collision
        view = sig.view(np.dtype((np.void, sig.shape[1] * 4))).ravel()
        _, first_idx, gid_of_block = np.unique(
            view, return_index=True, return_inverse=True
        )
        gid_of_block = gid_of_block.astype(np.int64).ravel()
        rep = sig[first_idx]
    return gid_of_block, rep


def group_table_rows(group_sig: np.ndarray, mn_cap: int) -> np.ndarray:
    """[G, R] kernel-facing group tables: each row selects to
    (mu[mn_cap], inv[mn_cap], w2[mn_cap], mnhalf), where inv = 1/std,
    w2 = w/std/mn and mnhalf = (mn+1)//2 (the production numba fail
    threshold, reference match_utils_numba.py:59)."""
    g = group_sig.shape[0]
    mu = group_sig[:, :mn_cap]
    std = group_sig[:, mn_cap : 2 * mn_cap]
    w = group_sig[:, 2 * mn_cap : 3 * mn_cap]
    mn = group_sig[:, 3 * mn_cap].astype(np.int64)
    r = 3 * mn_cap + 1
    out = np.zeros((g, r), dtype=np.float32)
    out[:, :mn_cap] = mu
    inv = (np.float32(1.0) / std).astype(np.float32)
    out[:, mn_cap : 2 * mn_cap] = inv
    w2 = (w * inv / np.maximum(mn, 1)[:, None].astype(np.float32))
    out[:, 2 * mn_cap : 3 * mn_cap] = w2.astype(np.float32)
    out[:, 3 * mn_cap] = ((mn + 1) // 2).astype(np.float32)
    return out


def block_distances(batch, first_row: np.ndarray) -> np.ndarray:
    """[NB, cmax] f32 conformer distances of each block's (u, v) ligand
    node pair — same f32 op sequence as screen_tiles.tile_distances so
    values are producer-independent."""
    ln = batch.ln
    d_idx = batch.sub_d_idx[first_row].astype(np.int64)
    li = d_idx // (ln * ln)
    rem = d_idx % (ln * ln)
    u = rem // ln
    v = rem % ln
    pos = batch.node_pos  # [B, Ln, C, 3] f32
    d = pos[li, u] - pos[li, v]  # [NB, C, 3]
    d2 = d[:, :, 0] * d[:, :, 0]
    d2 = d2 + d[:, :, 1] * d[:, :, 1]
    d2 = d2 + d[:, :, 2] * d[:, :, 2]
    return np.sqrt(d2, dtype=np.float32)


def build_v3_layout(
    batch,
    tile: int = TILE,
    g_cap: int = V3_G_CAP,
    mn_cap: int | None = None,
    nbt: int | None = None,
    model=None,
) -> V3Batch:
    """Build the v3 block-major layout from a ScreenBatch (or any object
    with its sub_*/block_*/pair_* fields, e.g. the native packer output).

    `nbt` pins the padded row count (for shard groups that must share
    shapes); defaults to the natural tiled size. Passing the PackedModel
    enables exact metadata group keys (group_ids_meta) — the fast path;
    without it grouping falls back to hashing the expanded block tables."""
    np_real = len(batch.pair_threshold)
    nb = len(batch.block_mn)
    cmax = batch.cmax
    if nb == 0:
        return _empty_v3(batch, np_real, cmax, tile, g_cap, nbt)

    mn, first_row = _block_offsets(batch)
    mn_cap = mn_cap or _round_up(max(int(mn.max(initial=1)), 1), 8)
    if mn.max(initial=0) > mn_cap:
        raise ValueError(f"mn {mn.max()} exceeds mn_cap {mn_cap}")
    grouped = group_ids_meta(batch, model, mn, first_row, mn_cap)
    if grouped is None:
        mu_b, std_b, w_b, _, _, _ = block_tables(batch, mn_cap)
        gid_of_block, group_sig = group_blocks(mu_b, std_b, w_b, mn)
    else:
        gid_of_block, group_sig = grouped
    tables = group_table_rows(group_sig, mn_cap)  # [G, R]

    blk_pair = batch.block_pair.astype(np.int64)
    counts = np.bincount(blk_pair, minlength=np_real)[:np_real]
    if counts.max(initial=0) > tile:
        raise ValueError("pair block span exceeds TILE")
    # blocks of one pair are emitted contiguously; first block of each pair
    pair_first_block = np.full(np_real, -1, np.int64)
    pair_first_block[blk_pair[::-1]] = np.arange(nb - 1, -1, -1)
    nonempty = np.nonzero(counts)[0]

    # sort pairs for group locality: by the group of their first block,
    # then pair id (stable, reproducible)
    order = nonempty[
        np.lexsort((nonempty, gid_of_block[pair_first_block[nonempty]]))
    ]

    # flattened block ids in sorted-pair row order (vectorized ragged
    # arange: repeat each pair's first block and add within-pair offsets)
    cnts = counts[order]
    cum = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(cnts, out=cum[1:])
    blocks_sorted = (
        np.repeat(pair_first_block[order], cnts)
        + np.arange(cum[-1]) - np.repeat(cum[:-1], cnts)
    )
    gids_sorted = gid_of_block[blocks_sorted]

    # --- greedy tile assembly: per TILE, take the longest pair prefix that
    # fits both the row budget and the group budget (binary search on the
    # group count — the loop runs once per tile, not once per pair). If a
    # single pair alone exceeds the group budget, grow g_cap to the next
    # power of two and redo ONLY this assembly (grouping/sorting above do
    # not depend on g_cap).
    n_sorted = len(order)
    while True:
        row_of_block = np.empty(nb, dtype=np.int64)
        slot_of_block = np.empty(nb, dtype=np.int32)
        pair_end = np.full(np_real, -1, np.int64)
        tile_group_lists: list[np.ndarray] = []
        pos = 0
        cursor = 0
        grown = False
        while pos < n_sorted:
            j = int(np.searchsorted(cum, cum[pos] + tile, side="right")) - 1
            j = max(j, pos + 1)  # a single pair always fits the row budget
            groups = np.unique(gids_sorted[cum[pos] : cum[j]])
            if len(groups) > g_cap:
                lo, hi = pos + 1, j  # largest j with <= g_cap distinct groups
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if len(np.unique(gids_sorted[cum[pos] : cum[mid]])) <= g_cap:
                        lo = mid
                    else:
                        hi = mid - 1
                j = lo
                groups = np.unique(gids_sorted[cum[pos] : cum[j]])
                if len(groups) > g_cap:
                    # one pair alone exceeds the budget: grow and retry
                    g_cap = 1 << int(np.ceil(np.log2(len(groups))))
                    grown = True
                    break
            span = int(cum[j] - cum[pos])
            rows = cursor + np.arange(span)
            blk = blocks_sorted[cum[pos] : cum[j]]
            row_of_block[blk] = rows
            # tile tables hold sorted unique gids: slot = searchsorted
            slot_of_block[blk] = np.searchsorted(
                groups, gids_sorted[cum[pos] : cum[j]]
            ).astype(np.int32)
            pair_end[order[pos:j]] = cursor + (cum[pos + 1 : j + 1] - cum[pos]) - 1
            tile_group_lists.append(groups)
            cursor = _round_up(cursor + span, tile)
            pos = j
        if not grown:
            break

    nbt_real = int(
        row_of_block[blocks_sorted[-1]] + 1) if n_sorted else 0
    nbt_padded = nbt or _round_up(max(cursor, 1), tile)
    if nbt_padded < cursor:
        raise ValueError(f"nbt {nbt_padded} < required rows {cursor}")
    t = nbt_padded // tile
    while len(tile_group_lists) < t:
        tile_group_lists.append(np.zeros(0, np.int64))
    assert len(tile_group_lists) == t

    # --- emit device arrays ----------------------------------------------
    r = tables.shape[1]
    r_pad = _round_up(r, 128)
    tab = np.zeros((t, g_cap, r_pad), dtype=np.float32)
    for ti, gl in enumerate(tile_group_lists):
        if len(gl):
            tab[ti, : len(gl), :r] = tables[gl]

    gid_rows = np.zeros(nbt_padded, dtype=np.int32)
    gid_rows[row_of_block] = slot_of_block

    dt_rows = np.zeros((nbt_padded, cmax), dtype=np.float32)
    dt_rows[row_of_block] = block_distances(batch, first_row)

    fp = np.ones(nbt_padded, dtype=np.float32)  # padding: own segments
    fp[row_of_block] = 0.0
    fp[row_of_block[pair_first_block[nonempty]]] = 1.0
    thr = np.full(nbt_padded, np.inf, dtype=np.float32)
    thr[row_of_block] = batch.pair_threshold[blk_pair]
    selfr = np.ones(nbt_padded, dtype=np.float32)
    selfr[row_of_block] = batch.pair_meta[blk_pair, 5].astype(np.float32)
    aux = np.stack([fp, thr, selfr], axis=0)  # [3, NBT]

    max_span = int(counts.max(initial=1))
    depth = int(np.ceil(np.log2(max_span))) if max_span > 1 else 0

    # pair alignment invariant: a real row on a tile boundary starts a pair
    boundary_rows = row_of_block[(row_of_block % tile) == 0]
    assert bool((fp[boundary_rows] == 1.0).all()), "v3 layout broke pair alignment"

    return V3Batch(
        dt=np.ascontiguousarray(
            dt_rows.reshape(t, tile, cmax).transpose(0, 2, 1)
        ),
        gid=gid_rows.reshape(t, tile),
        tab=tab,
        aux=np.ascontiguousarray(aux.reshape(3, t, tile).transpose(1, 0, 2)),
        depth=depth, mn_cap=mn_cap, g_cap=g_cap, nbt=nbt_real,
        pair_end_rows=pair_end,
        pair_threshold=batch.pair_threshold,
        pair_meta=batch.pair_meta,
        pair_slices=batch.pair_slices,
        candidates=batch.candidates,
        ligand_clusters=batch.ligand_clusters,
        num_conformers=batch.num_conformers,
        lig_cluster_center=batch.lig_cluster_center,
        lig_cluster_size=batch.lig_cluster_size,
        ln=batch.ln, cmax=cmax,
    )


def pad_v3(vb: V3Batch, t_bucket: int, tile: int = TILE) -> V3Batch:
    """Pad a V3Batch to `t_bucket` tiles with neutral tiles (padding rows
    are self-pair segments with infinite thresholds, so the kernel output
    on them is discarded by pair_end_rows compaction). Used to land shapes
    on the half-octave bucket grid, as the JAX package's engine does."""
    t = vb.dt.shape[0]
    if t_bucket <= t:
        return vb
    extra = t_bucket - t
    dt = np.concatenate(
        [vb.dt, np.zeros((extra, vb.dt.shape[1], tile), np.float32)], axis=0
    )
    gid = np.concatenate([vb.gid, np.zeros((extra, tile), np.int32)], axis=0)
    tab = np.concatenate(
        [vb.tab, np.zeros((extra,) + vb.tab.shape[1:], np.float32)], axis=0
    )
    aux = np.concatenate([vb.aux, _neutral_aux(extra, tile)], axis=0)
    return V3Batch(
        dt=dt, gid=gid, tab=tab, aux=aux,
        depth=vb.depth, mn_cap=vb.mn_cap, g_cap=vb.g_cap, nbt=vb.nbt,
        pair_end_rows=vb.pair_end_rows,
        pair_threshold=vb.pair_threshold,
        pair_meta=vb.pair_meta,
        pair_slices=vb.pair_slices,
        candidates=vb.candidates,
        ligand_clusters=vb.ligand_clusters,
        num_conformers=vb.num_conformers,
        lig_cluster_center=vb.lig_cluster_center,
        lig_cluster_size=vb.lig_cluster_size,
        ln=vb.ln, cmax=vb.cmax,
        ends_padded=vb.ends_padded,
    )


def _empty_v3(batch, np_real, cmax, tile, g_cap, nbt) -> V3Batch:
    t = max(1, (nbt or tile) // tile)
    mn_cap = 8
    return V3Batch(
        dt=np.zeros((t, cmax, tile), np.float32),
        gid=np.zeros((t, tile), np.int32),
        tab=np.zeros((t, g_cap, _round_up(3 * mn_cap + 1, 128)), np.float32),
        aux=_neutral_aux(t, tile),
        depth=0, mn_cap=mn_cap, g_cap=g_cap, nbt=0,
        pair_end_rows=np.full(np_real, -1, np.int64),
        pair_threshold=batch.pair_threshold,
        pair_meta=batch.pair_meta,
        pair_slices=batch.pair_slices,
        candidates=batch.candidates,
        ligand_clusters=batch.ligand_clusters,
        num_conformers=batch.num_conformers,
        lig_cluster_center=batch.lig_cluster_center,
        lig_cluster_size=batch.lig_cluster_size,
        ln=batch.ln, cmax=cmax,
    )


def _neutral_aux(t: int, tile: int) -> np.ndarray:
    """[T, 3, tile] neutral aux: every padding row is its own self-pair
    segment with an infinite fail threshold."""
    aux = np.empty((t, 3, tile), dtype=np.float32)
    aux[:, AUX3_FP] = 1.0
    aux[:, AUX3_THR] = np.inf
    aux[:, AUX3_SELF] = 1.0
    return aux
