"""Plain torch versions of the screening kernels (K1-K5) and of the probe
kernels (P1-P4).

Each function computes what its hand-written CUDA kernel in
csrc/screen_fused.cu computes, step by step as the JAX package's Pallas
kernels in pharmaconet_tpu/ops/screen_pallas.py (and the probe kernels of
the repo's probes/ scripts) do, with gathers and shift-adds in place of
the TPU's one-hot matmuls and lane rolls. The wrappers in
ops/screen_cuda.py call these for CPU tensors; the tests hold them against
the JAX functions, and chip_smoke.py holds the CUDA kernels against them
on the card.

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
  P1: d_table [NU, C] f32 unique distances, slots [NS] i32 rows into it
  P2: u_loc, v_loc [NS] i32 local node slots of each row's u and v
"""

from __future__ import annotations

import torch

from ..scoring.screen_tiles import NODE_CAP, TILE


def row_distances(pos_blocks: torch.Tensor, u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Conformer distances [T, C, tile] of each row's nodes u and w ([T,
    tile] slots into the tile's node table): sqrt((dx²+dy²)+dz²)."""
    t, threec, _ = pos_blocks.shape
    tile = u.shape[-1]
    u = u.long()[:, None, :].expand(t, threec, tile)
    w = w.long()[:, None, :].expand(t, threec, tile)
    dvec = (torch.gather(pos_blocks, 2, u) - torch.gather(pos_blocks, 2, w))
    dvec = dvec.reshape(t, threec // 3, 3, tile)
    dx, dy, dz = dvec[:, :, 0], dvec[:, :, 1], dvec[:, :, 2]
    return torch.sqrt((dx * dx + dy * dy) + dz * dz)


def packed_row_distances(pos_blocks: torch.Tensor, uv: torch.Tensor,
                          cap: int = NODE_CAP) -> torch.Tensor:
    """row_distances of rows packed as u_slot * cap + v_slot [T, tile]."""
    uvl = uv.long()
    return row_distances(pos_blocks, uvl // cap, uvl % cap)


def gauss_phase_tiles(
    pos_blocks: torch.Tensor, uv: torch.Tensor, mu: torch.Tensor,
    inv: torch.Tensor, winv: torch.Tensor, cap: int = NODE_CAP, noexp: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian phase per tile: returns (scores, pass counts), each
    [T, C, TILE]. d = sqrt((dx²+dy²)+dz²); x = (d-μ)·inv; a term is
    winv·exp(-x²/2) and a pass is x² < 4, both only where winv > 0."""
    d = packed_row_distances(pos_blocks, uv, cap)
    return gauss_phase_dt(d, mu, inv, winv, noexp=noexp)


def gauss_phase_dt(
    dt: torch.Tensor, mu: torch.Tensor, inv: torch.Tensor, winv: torch.Tensor,
    noexp: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian phase from conformer distances dt [T, C, tile] and tables
    [T, K, tile] (K = P model pairs, or mn_cap for K2): returns (scores,
    pass counts), each [T, C, tile], summed over K. `noexp` (P3's
    ablation) takes winv·x² as the term instead of winv·exp(-x²/2)."""
    x = (dt[:, None] - mu[:, :, None]) * inv[:, :, None]  # [T, K, C, tile]
    x2 = x * x
    w = winv[:, :, None]
    valid = w > 0.0
    term = torch.where(valid, w * (x2 if noexp else torch.exp(-0.5 * x2)), 0.0)
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


def scan_bounded_windows(val: torch.Tensor, seen: torch.Tensor, depth: int,
                         width: int = 32) -> torch.Tensor:
    """scan_bounded_tile computed window by window, as the CUDA K1 and K2
    scan inside each warp (csrc/screen_fused.cu `scan_rows`): each
    `width`-row window is scanned from its own rows plus the 2^depth - 1
    rows before it, and keeps its own rows. Rows before the tile are starts
    holding 0, and a row whose predecessor lies before its window acts as a
    start. After k steps a row depends only on its own and the 2^k - 1 rows
    before it, so every kept row equals scan_bounded_tile's bit for bit.
    Nothing on the screening path calls it: the tests prove the kernels'
    decomposition with it on the CPU."""
    t, r, tile = val.shape
    if tile % width:
        raise ValueError(f"the tile length {tile} is not a multiple of the window {width}")
    halo = (1 << depth) - 1
    dev = val.device
    firsts = torch.arange(0, tile, width, device=dev)[:, None]
    rows = firsts + torch.arange(-halo, width, device=dev)  # [windows, halo + width]
    real = rows >= 0
    flat = rows.clamp(min=0).reshape(-1)
    wval = torch.where(real.reshape(-1), val[..., flat], 0.0).reshape(t, r, *rows.shape)
    wseen = torch.where(real.reshape(-1), seen[..., flat], 1.0).reshape(t, *rows.shape)
    local = torch.arange(rows.shape[1], device=dev)
    shift = 1
    for _ in range(depth):
        if shift >= tile:
            break
        can = ((local >= shift) & (rows >= shift)).to(val.dtype)  # [windows, L]
        m = can * (1.0 - wseen)  # [T, windows, L]
        seen_r = torch.cat([torch.zeros_like(wseen[..., :shift]), wseen[..., :-shift]], dim=-1)
        seen_s = torch.maximum(seen_r * can, 1.0 - can)
        val_r = torch.cat([torch.zeros_like(wval[..., :shift]), wval[..., :-shift]], dim=-1)
        wval = wval + val_r * m[:, None]
        wseen = torch.maximum(wseen, seen_s)
        shift *= 2
    return wval[..., halo:].reshape(t, r, tile)


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


# --------------------------------------------------------------------------
# Probe kernels P1-P4 (the repo's probes/ scripts)
# --------------------------------------------------------------------------
ABLATIONS = ("full", "noscan", "noexp", "nohot", "gauss0")
VARIANTS = ("full", "b4d", "ohbf16")


def gaussian_phase_gather(
    d_table: torch.Tensor, slots: torch.Tensor, muT: torch.Tensor,
    invT: torch.Tensor, winvT: torch.Tensor,
) -> torch.Tensor:
    """P1 (probe_pallas_screen.py `gather_kernel`): the Gaussian phase with
    each row's C distances gathered from the unique-distance table
    d_table [NU, C] by its slot [NS]. Returns stacked [2C, NS] (rows
    [0, C) scores, [C, 2C) pass counts), K5's layout."""
    d = d_table[slots.long()].T  # [C, NS]
    scores, npass = gauss_phase_dt(d[None], muT[None], invT[None], winvT[None])
    return torch.cat([scores[0], npass[0]], dim=0)


def gaussian_phase_local(
    pos_blocks: torch.Tensor, u_loc: torch.Tensor, v_loc: torch.Tensor,
    muT: torch.Tensor, invT: torch.Tensor, winvT: torch.Tensor,
) -> torch.Tensor:
    """P2 (probe_pallas_screen.py `onehot_kernel`): the Gaussian phase with
    each row's distances rebuilt from its tile's node table, u and v given
    as two local slot rows u_loc, v_loc [NS]. Returns stacked [2C, NS]."""
    t = pos_blocks.shape[0]
    d = row_distances(pos_blocks, u_loc.reshape(t, TILE), v_loc.reshape(t, TILE))
    scores, npass = gauss_phase_dt(d, _tiles(muT), _tiles(invT), _tiles(winvT))
    return _untile(torch.cat([scores, npass], dim=1))


def score_tiles_fused_ablation(
    pos_blocks: torch.Tensor, uv: torch.Tensor, gtab: torch.Tensor,
    aux: torch.Tensor, depth1: int, depth2: int, mode: str,
) -> torch.Tensor:
    """P3 (probe_fused_split.py `make_kernel(mode)`): K1 with one stage
    removed, as [T*TILE, C] rows. `full` is K1; `noscan` skips the scans
    and the fail logic and writes scores + pass counts; `noexp` takes
    winv·x² as the term; `nohot` takes the constant distance
    1.5 + pos_blocks[t, 0, 0] instead of selecting the row's nodes;
    `gauss0` is nohot, noexp and noscan together."""
    if mode not in ABLATIONS:
        raise ValueError(f"unknown ablation {mode!r}; expected one of {ABLATIONS}")
    noscan, noexp = mode in ("noscan", "gauss0"), mode in ("noexp", "gauss0")
    mu, inv, winv = gtab[:, 0], gtab[:, 1], gtab[:, 2]
    if mode in ("nohot", "gauss0"):
        t, threec, _ = pos_blocks.shape
        d = (1.5 + pos_blocks[:, 0, 0])[:, None, None].expand(t, threec // 3, uv.shape[-1])
        scores, npass = gauss_phase_dt(d, mu, inv, winv, noexp=noexp)
    else:
        scores, npass = gauss_phase_tiles(pos_blocks, uv, mu, inv, winv, noexp=noexp)
    if noscan:
        table = scores + npass
    else:
        rows = [aux[:, j] for j in range(7)]
        table = scan_fail_tail(scores, npass, *rows, depth1, depth2)
    return _untile(table).T.contiguous()


def score_tiles_fused_variant(
    pos_blocks: torch.Tensor, uv: torch.Tensor, gtab: torch.Tensor,
    aux: torch.Tensor, depth1: int, depth2: int, mode: str,
) -> torch.Tensor:
    """P4 (probe_kernel_r3.py `make_kernel(mode)`): K1's function in a
    design variant (`full`, `b4d`, `ohbf16`); every mode computes K1's
    [T*TILE, C] rows, so this is K1's plain version."""
    if mode not in VARIANTS:
        raise ValueError(f"unknown variant {mode!r}; expected one of {VARIANTS}")
    return score_tiles_fused_rows(pos_blocks, uv, gtab, aux, depth1, depth2)


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P4 ohbf16's exact three-way split of f32 x into bf16 parts (hi, mid,
    lo), each held in f32: a part keeps the top 16 bits of the residual's
    int32 view (truncation, the kernel's __float2bfloat16_rz), and the next
    residual is x - part, exact in f32. (hi + mid) + lo == x wherever
    |x| >= 2^-110 or x = ±0 (-0 comes back +0, the same value, which no
    distance tells apart); below 2^-110 the lowest part can fall under
    bf16's subnormals and lose bits (every f32 subnormal, such as 1e-40,
    is below it). The packers write Å coordinates and zero padding."""
    parts = []
    for _ in range(3):
        part = (x.view(torch.int32) & -65536).view(torch.float32)
        parts.append(part)
        x = x - part
    return parts[0], parts[1], parts[2]


def mma_select_positions(pos_blocks: torch.Tensor, slots: torch.Tensor,
                         cap: int = NODE_CAP) -> torch.Tensor:
    """The node positions [T, 3C, tile] of each row's slot ([T, tile]) as
    P4 ohbf16 selects them on the tensor cores: the unsigned one-hot
    [tile, cap] of the slots times each bf16 part [cap, 3C] of the tile's
    node table, in f32 (one nonzero product per column, part * 1, so each
    product is the part exactly), then (hi + mid) + lo. A slot outside
    [0, cap) selects 0."""
    onehot = (slots.long()[..., None] == torch.arange(cap, device=slots.device)).float()
    hi, mid, lo = (torch.bmm(onehot, p.transpose(1, 2)) for p in split_bf16(pos_blocks))
    return ((hi + mid) + lo).transpose(1, 2)


def mma_row_distances(pos_blocks: torch.Tensor, uv: torch.Tensor,
                      cap: int = NODE_CAP) -> torch.Tensor:
    """P4 ohbf16's distances [T, C, tile] as its kernel forms them: both
    nodes' positions by mma_select_positions, d = pos_u - pos_v per axis,
    sqrt((dx²+dy²)+dz²)."""
    uvl = uv.long()
    dvec = mma_select_positions(pos_blocks, uvl // cap, cap) - \
        mma_select_positions(pos_blocks, uvl % cap, cap)
    t, threec, tile = dvec.shape
    dvec = dvec.reshape(t, threec // 3, 3, tile)
    dx, dy, dz = dvec[:, :, 0], dvec[:, :, 1], dvec[:, :, 2]
    return torch.sqrt((dx * dx + dy * dy) + dz * dz)
