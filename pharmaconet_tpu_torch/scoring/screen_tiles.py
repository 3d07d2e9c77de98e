"""Tiled screening layout (1024-row tiles with per-tile node tables).

The fused screening kernels (ops/screen_cuda.py) rebuild conformer
distances inside each tile from a per-tile node-position table, indexed by
the row's packed (u, v) slots. This module builds that layout on the host
from the untiled prep arrays (the `native_pack=False` route; the default
route packs it in one pass with native/pack_tiled.cpp):

  * sub rows are re-laid out in TILE-sized chunks; each tile references at
    most NODE_CAP distinct ligand nodes via a per-tile position table
  * node ids (li*ln + u) are disjoint across ligands, so capacity tracking
    is per-ligand: when appending a ligand's rows would overflow the
    current tile's node budget, the tile is padded to its boundary and the
    ligand starts a fresh tile
  * tiles are PAIR-ALIGNED: a pair whose row span would straddle a tile
    boundary is padded to start on the boundary instead, so NO scan
    segment ever crosses a tile and the kernels scan tile-locally
  * all per-row kernel inputs (gaussian tables, scan flags, block/pair end
    annotations) are scattered into the tiled positions; gaps get neutral
    padding (own segments, zero weight, +inf thresholds).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TILE = 1024
NODE_CAP = 64


@dataclass
class TiledScreenArgs:
    pos_blocks: np.ndarray  # [T, 3*C, NODE_CAP] per-tile node positions
    uv_packed: np.ndarray  # [1, NS_tiled] int32: u_loc * NODE_CAP + v_loc
    muT: np.ndarray  # [P, NS_tiled]
    invT: np.ndarray  # [P, NS_tiled]
    winvT: np.ndarray  # [P, NS_tiled]
    flags_block: np.ndarray  # [NS_tiled] bool
    flags_pair: np.ndarray  # [NS_tiled] bool
    end_mn_inv: np.ndarray  # [NS_tiled]
    end_mn_half: np.ndarray  # [NS_tiled]
    end_fail_gate: np.ndarray  # [NS_tiled]
    thr_ns: np.ndarray  # [NS_tiled]
    self_ns: np.ndarray  # [NS_tiled] bool
    pair_end_rows: np.ndarray  # [NP] int64 tiled row of each pair's last row (-1 if empty)
    depth1: int
    depth2: int


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def tile_distances(
    pos_blocks: np.ndarray,  # [T, 3C, cap]
    uv: np.ndarray,  # [T, tile] i32 (u_loc * cap + v_loc)
    cap: int = NODE_CAP,
    native: bool = True,
) -> np.ndarray:
    """The per-row conformer distances [T, C, tile] that K1 rebuilds in
    each tile, computed once at prepack time for v2 tile stores (K3 reads
    them instead). native=True runs native/dt_tiles.cpp; native=False the
    numpy path below. Both take the same f32 steps ((dx²+dy²)+dz², then
    sqrt, no fused multiply-add), so their outputs are bit-identical and a
    store does not depend on which one wrote it."""
    t, threec, _ = pos_blocks.shape
    c = threec // 3
    ntile = uv.shape[1]
    if native:
        from ..native import get_tile_dt

        out = np.empty((t, c, ntile), np.float32)
        get_tile_dt()(t, c, ntile, cap,
                      np.ascontiguousarray(pos_blocks, np.float32),
                      np.ascontiguousarray(uv, np.int32), out)
        return out
    u = (uv.astype(np.int64) // cap)[:, None, :]
    v = (uv.astype(np.int64) % cap)[:, None, :]
    pu = np.take_along_axis(pos_blocks, u, axis=2)  # [T, 3c, tile]
    pv = np.take_along_axis(pos_blocks, v, axis=2)
    d = (pu - pv).reshape(t, c, 3, ntile)
    d2 = d[:, :, 0] * d[:, :, 0]
    d2 = d2 + d[:, :, 1] * d[:, :, 1]
    d2 = d2 + d[:, :, 2] * d[:, :, 2]
    return np.sqrt(d2, dtype=np.float32)


def build_tiled_layout(
    batch,
    prep_args: tuple,
    depths: tuple[int, int],
    tile: int = TILE,
    node_cap: int = NODE_CAP,
    ns_tiled: int | None = None,
) -> TiledScreenArgs:
    """Transform untiled prep outputs (device_args arrays) into the tiled
    layout. `prep_args` is the numpy args tuple produced by
    BatchScreener.device_args."""
    (node_pos, muT, invT, winvT, _pu, _pv, _slot, flags_block, flags_pair,
     end_mn_inv, end_mn_half, end_fail_gate, thr_ns, self_ns) = (
        np.asarray(a) for a in prep_args
    )
    d1, d2 = depths
    ln = batch.ln
    b, _, c, _ = node_pos.shape
    p = muT.shape[0]
    ns_real = len(batch.sub_d_idx)

    if ns_real == 0:
        nst = ns_tiled or tile
        return _empty_layout(node_pos, p, c, nst, tile, node_cap, d1, d2,
                             len(batch.pair_threshold))

    idx = batch.sub_d_idx.astype(np.int64)
    li = idx // (ln * ln)
    rem = idx % (ln * ln)
    gu = li * ln + rem // ln
    gv = li * ln + rem % ln

    # rows are emitted ligand-contiguously by the packer
    rows_per_lig = np.bincount(li, minlength=b)
    cat = np.unique(np.concatenate([gu, gv]))
    nodes_per_lig = np.bincount(cat // ln, minlength=b)

    np_real = len(batch.pair_threshold)
    sub_pair = batch.block_pair[batch.sub_block].astype(np.int64)
    counts_pair = np.bincount(sub_pair, minlength=np_real)[:np_real]
    if counts_pair.max(initial=0) > tile:
        raise ValueError("pair row span exceeds TILE (cannot pair-align)")

    # greedy tile assembly: ligand-granular node budget + pair alignment.
    # Loop count = #ligands + #tile crossings (~NS/TILE) — small.
    pad_before_pair = np.zeros(np_real, dtype=np.int64)
    pos_cursor = 0  # row position in the tiled layout
    nodes_in_tile = 0
    for lig in range(b):
        r, n = int(rows_per_lig[lig]), int(nodes_per_lig[lig])
        if r == 0:
            continue
        if n > node_cap:
            raise ValueError(
                f"ligand {lig} references {n} nodes > NODE_CAP {node_cap}"
            )
        p0, p1 = batch.pair_slices[lig]
        spans = counts_pair[p0:p1]
        nz = np.nonzero(spans)[0]
        ends_rel = np.cumsum(spans)[nz]  # row end per nonempty pair
        starts_rel = ends_rel - spans[nz]
        in_tile = pos_cursor % tile
        if in_tile and nodes_in_tile + n > node_cap:
            pad = tile - in_tile
            pad_before_pair[p0 + nz[0]] += pad
            pos_cursor += pad
            nodes_in_tile = 0
        start = pos_cursor
        # pair-align every tile boundary the ligand's rows cross
        acc = 0
        next_b = (start // tile + 1) * tile
        j = 0
        while start + ends_rel[-1] + acc > next_b:
            # first pair ending strictly past the boundary
            k = j + int(
                np.searchsorted(ends_rel[j:] + acc, next_b - start, side="right")
            )
            p_start = start + int(starts_rel[k]) + acc
            if p_start < next_b:  # pair straddles: push it to the boundary
                pad = next_b - p_start
                pad_before_pair[p0 + nz[k]] += pad
                acc += pad
            j = k
            next_b += tile
        pos_cursor = start + int(ends_rel[-1]) + acc
        if (pos_cursor % tile) == 0:
            nodes_in_tile = 0
        elif (pos_cursor // tile) != (start // tile):
            # crossed at least one boundary: the live budget is what the
            # ligand re-registers in its last tile (conservative: all of it)
            nodes_in_tile = n
        else:
            nodes_in_tile += n

    shift = np.cumsum(pad_before_pair)  # [NP] total padding before each pair
    new_pos = np.arange(ns_real, dtype=np.int64) + shift[sub_pair]
    nst = ns_tiled or _round_up(int(new_pos[-1]) + 1, tile)
    assert nst >= int(new_pos[-1]) + 1
    num_tiles = nst // tile

    # --- per-tile node slots (vectorized) ---------------------------------
    tile_of_row = new_pos // tile
    span = b * ln
    key_u = tile_of_row * span + gu
    key_v = tile_of_row * span + gv
    uniq = np.unique(np.concatenate([key_u, key_v]))
    tile_of_key = uniq // span
    tile_start = np.searchsorted(tile_of_key, np.arange(num_tiles))
    slot_of_key = np.arange(len(uniq)) - tile_start[tile_of_key]
    if len(slot_of_key) and slot_of_key.max() >= node_cap:
        raise AssertionError("tile node budget exceeded (layout bug)")
    u_loc = slot_of_key[np.searchsorted(uniq, key_u)].astype(np.int32)
    v_loc = slot_of_key[np.searchsorted(uniq, key_v)].astype(np.int32)

    tile_nodes = np.zeros((num_tiles, node_cap), dtype=np.int64)
    tile_nodes[tile_of_key, slot_of_key] = uniq % span
    tile_used = np.zeros((num_tiles, node_cap), dtype=bool)
    tile_used[tile_of_key, slot_of_key] = True

    # --- per-tile position tables (unused slots zero) ------------------------
    pos_flat = np.ascontiguousarray(node_pos.reshape(b * ln, c * 3))
    pos_blocks = pos_flat[tile_nodes]  # [T, cap, 3c]
    pos_blocks[~tile_used] = 0.0
    pos_blocks = np.ascontiguousarray(np.transpose(pos_blocks, (0, 2, 1)))

    # --- scatter per-row arrays into tiled positions ------------------------
    uv_packed = np.zeros((1, nst), dtype=np.int32)
    uv_packed[0, new_pos] = u_loc * node_cap + v_loc

    def scatter_rows(src, default):
        out = np.full((p, nst), default, dtype=np.float32)
        out[:, new_pos] = src[:, :ns_real]
        return out

    def scatter1(src, default, dtype=np.float32):
        out = np.full(nst, default, dtype=dtype)
        out[new_pos] = src[:ns_real]
        return out

    t_muT = scatter_rows(muT, 0.0)
    t_invT = scatter_rows(invT, 1.0)
    t_winvT = scatter_rows(winvT, 0.0)
    t_flags_block = scatter1(flags_block, True, bool)
    t_flags_pair = scatter1(flags_pair, True, bool)
    t_end_mn_inv = scatter1(end_mn_inv, 0.0)
    t_end_mn_half = scatter1(end_mn_half, 0.0)
    t_end_fail_gate = scatter1(end_fail_gate, 0.0)
    t_thr = scatter1(thr_ns, np.inf)
    t_self = scatter1(self_ns, True, bool)

    # pair alignment invariant: every real row on a tile boundary starts a
    # pair (the fused kernels' tile-local scans depend on it)
    on_boundary = (new_pos % tile) == 0
    assert bool(flags_pair[:ns_real][on_boundary].all()), (
        "tiled layout broke pair alignment"
    )

    # --- pair end rows (tiled positions) ------------------------------------
    cum = np.cumsum(counts_pair)
    pair_end_rows = np.where(
        counts_pair > 0, new_pos[np.clip(cum - 1, 0, None)], -1
    )

    return TiledScreenArgs(
        pos_blocks=pos_blocks.astype(np.float32),
        uv_packed=uv_packed,
        muT=t_muT, invT=t_invT, winvT=t_winvT,
        flags_block=t_flags_block, flags_pair=t_flags_pair,
        end_mn_inv=t_end_mn_inv, end_mn_half=t_end_mn_half,
        end_fail_gate=t_end_fail_gate, thr_ns=t_thr, self_ns=t_self,
        pair_end_rows=pair_end_rows.astype(np.int64),
        depth1=d1, depth2=d2,
    )


def _empty_layout(node_pos, p, c, nst, tile, node_cap, d1, d2, np_real):
    num_tiles = nst // tile
    return TiledScreenArgs(
        pos_blocks=np.zeros((num_tiles, 3 * c, node_cap), np.float32),
        uv_packed=np.zeros((1, nst), np.int32),
        muT=np.zeros((p, nst), np.float32),
        invT=np.ones((p, nst), np.float32),
        winvT=np.zeros((p, nst), np.float32),
        flags_block=np.ones(nst, bool),
        flags_pair=np.ones(nst, bool),
        end_mn_inv=np.zeros(nst, np.float32),
        end_mn_half=np.zeros(nst, np.float32),
        end_fail_gate=np.zeros(nst, np.float32),
        thr_ns=np.full(nst, np.inf, np.float32),
        self_ns=np.ones(nst, bool),
        pair_end_rows=np.full(np_real, -1, np.int64),
        depth1=d1, depth2=d2,
    )
