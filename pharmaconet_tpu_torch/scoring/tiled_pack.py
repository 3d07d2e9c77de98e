"""One-pass native pack: ligand batch -> final tiled kernel layout (K1).

The three-pass host pipeline (build_batch -> device_args -> build_tiled_
layout) builds an [NS, P] row-major intermediate, transposes it lane-major
and scatters it into tiled positions. native/pack_tiled.cpp emits the
device arrays in their final form in a single enumeration pass (and can
shard ligand ranges across threads; each thread's segment is tile-aligned
so the merge is a handful of memcpys).

Array semantics are identical to the reference path — tests enforce
element equality of every device input against build_tiled_layout.

Layout v2 (tile-major, so width padding never copies):
  gtab [T, 3, P, tile]  (mu / 1/std / w/std)
  aux  [T, 7, tile]     (flags + end annotations + thr + is_self, f32)
  uv   [T, tile] i32    pos_blocks [T, 3*cmax, cap]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .batch_screen import (
    BLOCK_P,
    PackedLigand,
    PackedModel,
    _bucket_up,
    _flatten_ligands,
    _ligand_arrays,
)
from .screen_tiles import NODE_CAP, TILE

AUX_FB, AUX_FP, AUX_MNINV, AUX_MNHALF, AUX_GATE, AUX_THR, AUX_SELF = range(7)


@dataclass
class TiledBatch:
    # device inputs (tile-major layout)
    gtab: np.ndarray  # [T, 3, P, tile]
    aux: np.ndarray  # [T, 7, tile]
    uv: np.ndarray  # [T, tile] i32
    pos_blocks: np.ndarray  # [T, 3*cmax, cap]
    depth1: int
    depth2: int
    nst: int  # real rows (<= T * tile)
    # host metadata (compact / prune / DFS) — duck-compatible with the
    # ScreenBatch fields those helpers read
    pair_end_rows: np.ndarray  # [NP]
    pair_threshold: np.ndarray  # [NP]
    pair_meta: np.ndarray  # [NP, 6]
    pair_slices: list
    candidates: list
    ligand_clusters: list
    num_conformers: np.ndarray
    lig_cluster_center: np.ndarray
    lig_cluster_size: np.ndarray
    ln: int
    cmax: int


def build_tiled_batch(
    model: PackedModel,
    ligands: list[PackedLigand],
    threads: int = 1,
    rows_hint: int | None = None,
    width: int | None = None,
    buffer_cache: dict | None = None,
    cmax: int | None = None,
) -> TiledBatch:
    """Pack ligands straight into the tiled device layout (C++; a failed
    build of the native library raises). `rows_hint` seeds the width guess
    (callers keep a running rows-per-ligand average); `width` pins the
    final padded width exactly and `cmax` the conformer-slot count
    (batches that must share shapes; phantom conformer slots are
    zero-padded and never read — the DFS consumes per-ligand counts).

    `buffer_cache` (a dict owned by the caller) reuses output arrays
    across batches of the same padded shape: numpy releases >128 KB blocks
    back to the OS on free, so fresh ~200 MB allocations re-page-fault
    every batch. The returned TiledBatch ALIASES the cache — consume it
    (copy it to the device) before the next build call with the same
    cache."""
    from ..native import get_pack_tiled

    fn = get_pack_tiled()
    fl = _flatten_ligands(model, ligands, cmax=cmax)
    num_ligands = len(ligands)
    node_pos, num_conf, lig_center, lig_size, _ = _ligand_arrays(
        ligands, fl.ln, fl.cmax, fl.lmax
    )
    threec = 3 * fl.cmax

    ct_offsets, ct_nodes = model.ct_tables()
    mu = np.ascontiguousarray(model.mu)
    std = np.ascontiguousarray(model.std)
    weight = np.ascontiguousarray(model.weight)
    pos_flat = np.ascontiguousarray(node_pos.reshape(num_ligands * fl.ln, threec))

    guess_rows = rows_hint if rows_hint else 600 * num_ligands
    if width is not None:
        t_alloc = width // TILE
        assert width % TILE == 0
    else:
        t_alloc = (_bucket_up(max(guess_rows, 1)) + TILE - 1) // TILE
    cap_np = max(1024, 1024 * num_ligands)

    while True:
        key = (t_alloc, cap_np, threec, num_ligands)
        cached = buffer_cache.get(key) if buffer_cache is not None else None
        if cached is None:
            gtab = np.empty((t_alloc, 3, BLOCK_P, TILE), dtype=np.float32)
            aux = np.empty((t_alloc, 7, TILE), dtype=np.float32)
            uv = np.empty((t_alloc, TILE), dtype=np.int32)
            pos_blocks = np.empty((t_alloc, threec, NODE_CAP), dtype=np.float32)
            pair_threshold = np.empty(cap_np, dtype=np.float32)
            pair_meta = np.empty((cap_np, 6), dtype=np.int32)
            pair_end_rows = np.empty(cap_np, dtype=np.int64)
            pair_slices = np.empty((num_ligands, 2), dtype=np.int64)
            if buffer_cache is not None:
                buffer_cache.clear()  # one live shape per cache
                buffer_cache[key] = (
                    gtab, aux, uv, pos_blocks, pair_threshold, pair_meta,
                    pair_end_rows, pair_slices,
                )
        else:
            (gtab, aux, uv, pos_blocks, pair_threshold, pair_meta,
             pair_end_rows, pair_slices) = cached
        out = np.zeros(4, dtype=np.int64)
        rc = fn(
            len(model.cluster_nodes), len(model.weight),
            ct_offsets, ct_nodes, mu, std, weight,
            num_ligands, fl.ln, fl.cmax,
            fl.lig_cluster_offsets, fl.member_offsets, fl.members,
            fl.node_mask_offsets, fl.node_masks_flat,
            fl.active_offsets, fl.active_flat,
            fl.cand_offsets, fl.cands_flat,
            pos_flat,
            BLOCK_P, TILE, NODE_CAP, max(1, threads),
            t_alloc, cap_np,
            gtab, aux, uv, pos_blocks,
            pair_threshold, pair_meta, pair_end_rows, pair_slices.reshape(-1),
            out,
        )
        if rc == 0:
            break
        if rc == -1:
            if width is not None:
                raise ValueError(
                    f"pinned width {width} < required rows {int(out[0])}"
                )
            t_alloc = (_bucket_up(int(out[0])) + TILE - 1) // TILE
        elif rc == -2:
            cap_np = max(int(out[1]), cap_np * 2)
        elif rc == -4:
            raise MemoryError(
                "tiled pack: staging allocation failed (host out of memory)"
            )
        else:
            raise ValueError(
                "tiled pack failed: ligand node count exceeds NODE_CAP or "
                "a pair span exceeds TILE"
            )

    nst, npairs = int(out[0]), int(out[1])
    max_block, max_pair = max(1, int(out[2])), max(1, int(out[3]))
    d1 = max(1, int(np.ceil(np.log2(max_block))))
    d2 = max(2, int(np.ceil(np.log2(max_pair))))
    return TiledBatch(
        gtab=gtab, aux=aux, uv=uv, pos_blocks=pos_blocks,
        depth1=d1, depth2=d2, nst=nst,
        pair_end_rows=pair_end_rows[:npairs],
        pair_threshold=pair_threshold[:npairs],
        pair_meta=pair_meta[:npairs],
        pair_slices=[(int(a), int(b)) for a, b in pair_slices],
        candidates=fl.candidates_all,
        ligand_clusters=fl.cluster_counts,
        num_conformers=num_conf,
        lig_cluster_center=lig_center,
        lig_cluster_size=lig_size,
        ln=fl.ln, cmax=fl.cmax,
    )
