"""Host preparation of the probe kernels' inputs (numpy).

The counterparts of the set-up code in the repo's `probes/` scripts,
written as functions:

  * `headline_inputs` — the probes' workload: the 20-cluster synthetic
    model (seed 0) and synthetic ligands (seed 1, 4 conformers), the
    repo's benchmark shape.
  * `row_batch` — the untiled row layout the reference engine scores
    (`BatchScreener.device_args`), with its Gaussian tables padded to a
    TILE multiple for P1 and P2.
  * `gather_inputs` — P1's unique-distance table `d_table [NU, C]`, built
    with numpy from the batch's node positions, and each row's slot into
    it (probe_pallas_screen.py:99-104 and :261-263).
  * `local_tables` — P2's per-tile node tables: each 1024-row chunk of the
    untiled rows gets the sorted unique ligand nodes its rows reference
    (at most NODE_CAP; `overflow` counts the tiles that needed more and
    were cut), the rows' local (u, v) indices into them and the tiles'
    node positions `pos_blocks [T, 3C, NODE_CAP]`
    (probe_pallas_screen.py:151-186).
  * `tiled_inputs` — K1's tile-major layout from the one-pass pack, the
    inputs of P3 and P4 (probe_fused_split.py:42-55).

The TPU probes padded `slot_rows` and `uv_rows` to 8 sublanes; here slots
are `[ns_t]` i32 and the local indices `[2, ns_t]` i32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..scoring.batch_screen import (
    BatchScreener,
    PackedModel,
    ScreenBatch,
    build_batch,
    unique_distance_table,
)
from ..scoring.screen_tiles import NODE_CAP, TILE
from ..scoring.tiled_pack import build_tiled_batch
from ..synthetic import make_synthetic_ligands, make_synthetic_model

HEADLINE_LIGANDS = 2048


def headline_inputs(n_ligands: int = HEADLINE_LIGANDS, num_conformers: int = 4):
    """(packed model, packed ligands) of the probes' workload."""
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    return pm, make_synthetic_ligands(n_ligands, num_conformers=num_conformers, seed=1)


@dataclass
class RowBatch:
    batch: ScreenBatch
    args: tuple  # BatchScreener.device_args arrays: the reference engine's inputs
    depth1: int
    depth2: int
    ns: int  # rows the reference engine scans (half-octave bucket)
    ns_t: int  # ns rounded up to TILE: the P1/P2 grid width
    muT: np.ndarray  # [P, ns_t] f32, padding mu 0
    invT: np.ndarray  # [P, ns_t] f32, padding 1
    winvT: np.ndarray  # [P, ns_t] f32, padding 0 (no term, no pass)

    @property
    def ns_real(self) -> int:
        return len(self.batch.sub_d_idx)


def _pad_cols(a: np.ndarray, width: int, value: float) -> np.ndarray:
    out = np.full((a.shape[0], width), value, dtype=np.float32)
    out[:, : a.shape[1]] = a
    return out


def row_batch(pm: PackedModel, ligands) -> RowBatch:
    batch = build_batch(pm, ligands)
    args, (d1, d2) = BatchScreener(pm, device="cpu").device_args(batch)
    ns = args[1].shape[1]
    ns_t = -(-ns // TILE) * TILE
    return RowBatch(
        batch=batch, args=args, depth1=d1, depth2=d2, ns=ns, ns_t=ns_t,
        muT=_pad_cols(args[1], ns_t, 0.0), invT=_pad_cols(args[2], ns_t, 1.0),
        winvT=_pad_cols(args[3], ns_t, 0.0),
    )


@dataclass
class GatherInputs:
    d_table: np.ndarray  # [NU, C] f32 conformer distances of each unique (ligand, u, v)
    slots: np.ndarray  # [ns_t] i32 row -> d_table row (padding rows: 0, zero weight)


def gather_inputs(rb: RowBatch) -> GatherInputs:
    pair_u, pair_v, sub_slot = unique_distance_table(rb.batch)
    node_pos = rb.batch.node_pos
    pos_all = node_pos.reshape(-1, node_pos.shape[2], 3)
    d_table = np.linalg.norm(pos_all[pair_u] - pos_all[pair_v], axis=-1).astype(np.float32)
    slots = np.zeros(rb.ns_t, np.int32)
    slots[: rb.ns_real] = sub_slot
    return GatherInputs(d_table=np.ascontiguousarray(d_table), slots=slots)


@dataclass
class LocalTables:
    pos_blocks: np.ndarray  # [T, 3C, NODE_CAP] f32 node positions of each tile
    uv_loc: np.ndarray  # [2, ns_t] i32 local u and v of each row
    tile_nodes: np.ndarray  # [T, NODE_CAP] i64 global node row of each slot (0 past the used)
    gu: np.ndarray  # [ns_t] i64 global node row of each row's u (padding rows: 0)
    gv: np.ndarray  # [ns_t] i64
    max_union: int  # most distinct nodes one tile's rows reference
    overflow: int  # tiles that referenced more than NODE_CAP (their tables cut)


def local_tables(rb: RowBatch, cap: int = NODE_CAP) -> LocalTables:
    ln = rb.batch.ln
    idx = rb.batch.sub_d_idx.astype(np.int64)
    li, rem = idx // (ln * ln), idx % (ln * ln)
    gu = np.zeros(rb.ns_t, np.int64)  # global node rows (ligand * Ln + node)
    gv = np.zeros(rb.ns_t, np.int64)
    gu[: rb.ns_real] = li * ln + rem // ln
    gv[: rb.ns_real] = li * ln + rem % ln
    t_count = rb.ns_t // TILE
    tile_nodes = np.zeros((t_count, cap), np.int64)
    uv_loc = np.zeros((2, t_count, TILE), np.int32)
    max_union = overflow = 0
    for t in range(t_count):
        sl = slice(t * TILE, (t + 1) * TILE)
        nodes = np.unique(np.concatenate([gu[sl], gv[sl]]))
        max_union = max(max_union, len(nodes))
        if len(nodes) > cap:
            overflow += 1
            nodes = nodes[:cap]
        tile_nodes[t, : len(nodes)] = nodes
        uv_loc[0, t] = np.clip(np.searchsorted(nodes, gu[sl]), 0, cap - 1)
        uv_loc[1, t] = np.clip(np.searchsorted(nodes, gv[sl]), 0, cap - 1)
    node_pos = rb.batch.node_pos
    pos_flat = node_pos.reshape(-1, node_pos.shape[2] * 3)  # [B*Ln, 3C], row 3c+k
    pos_blocks = np.ascontiguousarray(np.transpose(pos_flat[tile_nodes], (0, 2, 1)))
    return LocalTables(
        pos_blocks=pos_blocks.astype(np.float32), uv_loc=uv_loc.reshape(2, rb.ns_t),
        tile_nodes=tile_nodes, gu=gu, gv=gv, max_union=max_union, overflow=overflow,
    )


@dataclass
class TiledInputs:
    pos_blocks: np.ndarray  # [T, 3C, NODE_CAP] f32
    uv: np.ndarray  # [T, TILE] i32 u_slot * NODE_CAP + v_slot
    gtab: np.ndarray  # [T, 3, P, TILE] f32
    aux: np.ndarray  # [T, 7, TILE] f32
    depth1: int
    depth2: int

    @property
    def arrays(self) -> tuple:
        return self.pos_blocks, self.uv, self.gtab, self.aux


def tiled_inputs(pm: PackedModel, ligands, threads: int = 1) -> TiledInputs:
    """K1's inputs for the tiles that hold rows (the tiles `dispatch_tb`
    sends; the width bucket's padding stays on the host)."""
    tb = build_tiled_batch(pm, ligands, threads=threads)
    used = max(1, -(-tb.nst // TILE))
    return TiledInputs(
        *(np.ascontiguousarray(a[:used]) for a in (tb.pos_blocks, tb.uv, tb.gtab, tb.aux)),
        depth1=tb.depth1, depth2=tb.depth2,
    )
