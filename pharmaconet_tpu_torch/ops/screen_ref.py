"""Plain torch versions of the screening kernels (K1-K5).

Each function computes what its hand-written CUDA kernel in
csrc/screen_fused.cu computes, step by step as the JAX package's Pallas
kernels in pharmaconet_tpu/ops/screen_pallas.py do, with gathers and
shift-adds in place of the TPU's one-hot matmuls and lane rolls. The
wrappers in ops/screen_cuda.py call these for CPU tensors; the tests hold
them against the JAX functions, and chip_smoke.py holds the CUDA kernels
against them on the card.

Shapes (C conformers, P = 8 model pairs, TILE = 1024 rows, T tiles):
  pos_blocks [T, 3C, NODE_CAP] f32   per-tile node positions (row 3c+k)
  uv         [T, TILE] i32           u_slot * NODE_CAP + v_slot
  dt         [T, C, TILE] f32        stored conformer distances (K2, K3)
  mu/inv/winv [T, P, TILE] f32       Gaussian tables (0 weight = padding)
  aux rows   [T, TILE] f32 each      flags_block, flags_pair, end_mn_inv,
                                     end_mn_half, end_fail_gate, thr, is_self
  K2 (v3 layout): gid [T, TILE] i32 group slot, tab [T, G, R] f32 group
  tables (rows [0, mn) mu, [mn, 2mn) 1/std, [2mn, 3mn) w2, 3mn mnhalf),
  aux [T, 3, TILE] f32 (pair-start flag, thr, is_self)
"""

from __future__ import annotations

import torch

from ..scoring.screen_tiles import NODE_CAP, TILE


def gauss_phase_tiles(
    pos_blocks: torch.Tensor, uv: torch.Tensor, mu: torch.Tensor,
    inv: torch.Tensor, winv: torch.Tensor, cap: int = NODE_CAP,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian phase per tile: returns (scores, pass counts), each
    [T, C, TILE]. d = sqrt((dx²+dy²)+dz²); x = (d-μ)·inv; a term is
    winv·exp(-x²/2) and a pass is x² < 4, both only where winv > 0."""
    t, threec, _ = pos_blocks.shape
    c = threec // 3
    tile = uv.shape[-1]
    uvl = uv.long()
    u = (uvl // cap)[:, None, :].expand(t, threec, tile)
    v = (uvl % cap)[:, None, :].expand(t, threec, tile)
    dvec = (torch.gather(pos_blocks, 2, u) - torch.gather(pos_blocks, 2, v))
    dvec = dvec.reshape(t, c, 3, tile)
    dx, dy, dz = dvec[:, :, 0], dvec[:, :, 1], dvec[:, :, 2]
    d = torch.sqrt((dx * dx + dy * dy) + dz * dz)  # [T, C, tile]
    return gauss_phase_dt(d, mu, inv, winv)


def gauss_phase_dt(
    dt: torch.Tensor, mu: torch.Tensor, inv: torch.Tensor, winv: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian phase from conformer distances dt [T, C, tile] and tables
    [T, K, tile] (K = P model pairs, or mn_cap for K2): returns (scores,
    pass counts), each [T, C, tile], summed over K."""
    x = (dt[:, None] - mu[:, :, None]) * inv[:, :, None]  # [T, K, C, tile]
    x2 = x * x
    w = winv[:, :, None]
    valid = w > 0.0
    term = torch.where(valid, w * torch.exp(-0.5 * x2), 0.0)
    hit = torch.where(valid & (x2 < 4.0), 1.0, 0.0)
    return term.sum(dim=1), hit.sum(dim=1)


def scan_bounded_tile(val: torch.Tensor, seen: torch.Tensor, depth: int) -> torch.Tensor:
    """Tile-local bounded segmented inclusive scan along the last axis.

    val [T, R, TILE] f32, seen [T, TILE] f32 (1.0 = segment start). Lanes
    below the shift act as segment starts (segments never cross a tile,
    the layout is pair-aligned). The recurrence of the JAX
    `_scan_bounded_tile`, with the roll + edge mask as a shift."""
    tile = val.shape[-1]
    lanes = torch.arange(tile, device=val.device)
    shift = 1
    for _ in range(depth):
        if shift >= tile:
            break  # every lane is below the shift: nothing changes
        can = (lanes >= shift).to(val.dtype)  # [tile]
        m = can * (1.0 - seen)  # [T, tile]
        seen_r = torch.cat([torch.zeros_like(seen[:, :shift]), seen[:, :-shift]], dim=-1)
        seen_s = torch.maximum(seen_r * can, 1.0 - can)
        val_r = torch.cat([torch.zeros_like(val[..., :shift]), val[..., :-shift]], dim=-1)
        val = val + val_r * m[:, None, :]
        seen = torch.maximum(seen, seen_s)
        shift *= 2
    return val


def scan_fail_tail(
    scores: torch.Tensor, npass: torch.Tensor, fb, fp, mninv, mnhalf, gate,
    thr, selff, depth1: int, depth2: int,
) -> torch.Tensor:
    """Both scans + block/pair fail logic per tile: [T, C, TILE] -> the
    pair table [T, C, TILE] (scores at pair-end rows, -1 on failed cross
    pairs). The flag and annotation rows are [T, TILE] f32."""
    c = scores.shape[1]
    sb = scan_bounded_tile(torch.cat([scores, npass], dim=1), fb, depth1)
    scan_s, scan_p = sb[:, :c], sb[:, c:]
    block_score = scan_s * mninv[:, None, :]
    block_fail = torch.where(scan_p < mnhalf[:, None, :], gate[:, None, :], 0.0)
    pb = scan_bounded_tile(torch.cat([block_score, block_fail], dim=1), fp, depth2)
    pair_score, pair_fail = pb[:, :c], pb[:, c:]
    failed = pair_fail > thr[:, None, :]
    not_self = (selff == 0.0)[:, None, :]
    return torch.where(failed & not_self, -1.0, pair_score)


def _tiles(a: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """[R, NS] row-layout array -> [T, R, tile]."""
    r, ns = a.shape
    return a.reshape(r, ns // tile, tile).permute(1, 0, 2)


def _untile(a: torch.Tensor) -> torch.Tensor:
    """[T, R, tile] -> [R, T*tile]."""
    t, r, tile = a.shape
    return a.permute(1, 0, 2).reshape(r, t * tile)


def score_tiles_fused(
    pos_blocks: torch.Tensor, uv: torch.Tensor, gtab: torch.Tensor,
    aux: torch.Tensor, depth1: int, depth2: int,
) -> torch.Tensor:
    """K1 over the tile-major layout (gtab [T, 3, P, TILE], aux
    [T, 7, TILE]); returns the expanded [C, T*TILE] table."""
    scores, npass = gauss_phase_tiles(pos_blocks, uv, gtab[:, 0], gtab[:, 1], gtab[:, 2])
    rows = [aux[:, j] for j in range(7)]
    return _untile(scan_fail_tail(scores, npass, *rows, depth1, depth2))


def score_tiles_fused_rows(
    pos_blocks: torch.Tensor, uv: torch.Tensor, gtab: torch.Tensor,
    aux: torch.Tensor, depth1: int, depth2: int,
) -> torch.Tensor:
    """score_tiles_fused as [T*TILE, C] rows (the layout the host's pair
    compaction reads)."""
    return score_tiles_fused(pos_blocks, uv, gtab, aux, depth1, depth2).T.contiguous()


def score_tiles_fused_dt(
    dt: torch.Tensor, gtab: torch.Tensor, aux: torch.Tensor,
    depth1: int, depth2: int,
) -> torch.Tensor:
    """K3: K1 with the conformer distances read from the store's dt
    [T, C, TILE] instead of rebuilt from node tables; returns the expanded
    [C, T*TILE] table. The counterpart of the JAX `score_tiles_fused_dt`."""
    scores, npass = gauss_phase_dt(dt, gtab[:, 0], gtab[:, 1], gtab[:, 2])
    rows = [aux[:, j] for j in range(7)]
    return _untile(scan_fail_tail(scores, npass, *rows, depth1, depth2))


def score_tiles_fused_dt_rows(
    dt: torch.Tensor, gtab: torch.Tensor, aux: torch.Tensor,
    depth1: int, depth2: int,
) -> torch.Tensor:
    """score_tiles_fused_dt as [T*TILE, C] rows."""
    return score_tiles_fused_dt(dt, gtab, aux, depth1, depth2).T.contiguous()


def score_tiles_v3(
    dt: torch.Tensor, gid: torch.Tensor, tab: torch.Tensor, aux: torch.Tensor,
    depth: int, mn_cap: int,
) -> torch.Tensor:
    """K2 over the v3 block-major layout: each row reads its group's
    (mu, 1/std, w2, mnhalf) from the tile's table by `gid`, sums the
    Gaussian terms and passes over mn_cap, sets the block fail in-row
    (passes < mnhalf on a cross pair), runs ONE pair-level bounded scan of
    [score; block_fail] over the pair-start flags, and writes -1 where a
    cross pair's fails exceed its threshold. Returns the expanded
    [C, T*TILE] table. The counterpart of the JAX `score_tiles_v3`."""
    t, c, tile = dt.shape
    sel = torch.gather(
        tab, 1, gid.long()[:, :, None].expand(t, tile, tab.shape[2])
    ).transpose(1, 2)  # [T, R, tile]
    mu = sel[:, :mn_cap]
    inv = sel[:, mn_cap : 2 * mn_cap]
    w2 = sel[:, 2 * mn_cap : 3 * mn_cap]
    mnhalf = sel[:, 3 * mn_cap]  # [T, tile]
    score, npass = gauss_phase_dt(dt, mu, inv, w2)
    fp, thr, selff = aux[:, 0], aux[:, 1], aux[:, 2]
    block_fail = torch.where(npass < mnhalf[:, None], (1.0 - selff)[:, None], 0.0)
    pb = scan_bounded_tile(torch.cat([score, block_fail], dim=1), fp, depth)
    pair_score, pair_fail = pb[:, :c], pb[:, c:]
    failed = (pair_fail > thr[:, None]) & (selff == 0.0)[:, None]
    return _untile(torch.where(failed, -1.0, pair_score))


def score_tiles_v3_rows(
    dt: torch.Tensor, gid: torch.Tensor, tab: torch.Tensor, aux: torch.Tensor,
    depth: int, mn_cap: int,
) -> torch.Tensor:
    """score_tiles_v3 as [T*TILE, C] rows."""
    return score_tiles_v3(dt, gid, tab, aux, depth, mn_cap).T.contiguous()


def score_blocks_fused(
    pos_blocks: torch.Tensor, uv_packed: torch.Tensor, muT: torch.Tensor,
    invT: torch.Tensor, winvT: torch.Tensor, flags_block, flags_pair,
    end_mn_inv, end_mn_half, end_fail_gate, thr_ns, self_ns,
    depth1: int, depth2: int,
) -> torch.Tensor:
    """K4: K1's arithmetic over the row layout (uv [1, NS], μ/inv/winv
    [P, NS], seven [NS] rows); returns the expanded [C, NS] table. The
    counterpart of the JAX `score_blocks_pallas_fused`."""
    t = pos_blocks.shape[0]
    scores, npass = gauss_phase_tiles(
        pos_blocks, uv_packed.reshape(t, TILE), _tiles(muT), _tiles(invT),
        _tiles(winvT),
    )
    rows = [
        a.to(torch.float32).reshape(t, TILE)
        for a in (flags_block, flags_pair, end_mn_inv, end_mn_half,
                  end_fail_gate, thr_ns, self_ns)
    ]
    return _untile(scan_fail_tail(scores, npass, *rows, depth1, depth2))


def gaussian_phase(
    pos_blocks: torch.Tensor, uv_packed: torch.Tensor, muT: torch.Tensor,
    invT: torch.Tensor, winvT: torch.Tensor,
) -> torch.Tensor:
    """K5: the Gaussian phase alone over the row layout; returns stacked
    [2C, NS] (rows [0, C) scores, [C, 2C) pass counts). The counterpart of
    the JAX `gaussian_phase_pallas`."""
    t = pos_blocks.shape[0]
    scores, npass = gauss_phase_tiles(
        pos_blocks, uv_packed.reshape(t, TILE), _tiles(muT), _tiles(invT),
        _tiles(winvT),
    )
    return _untile(torch.cat([scores, npass], dim=1))
