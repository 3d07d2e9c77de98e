"""Atom -> voxel-grid rasterization: the plain torch version of K6.

The same arithmetic as the JAX package's `ops/voxelize.py`, in its order of
operations: per voxel and atom the exact f32 per-axis squared distance
d2 = (dx*dx + dy*dy) + dz*dz, rbf = exp(-d2 / (2 (sigma*r)^2)) where
d2 <= r^2 (r = 1.5), image = rbf @ feats (33 channels, f32), and
occupancy = any(d2 <= 1.0^2). Invalid (padding) atoms get an additive 1e30
distance penalty, so they reach neither output.

The CUDA kernel (`ops/voxelize_cuda.py`, `csrc/voxelize.cu`) computes the
same function; this version serves the CPU tests, CPU tensors, the
`PharmacoNet(voxelizer="reference")` path and the on-card comparison.
`voxelize_numpy` is the direct per-atom loop the tests check both against.

`bin_atoms_reference`, `tile_candidates_reference` and `voxelize_binned`
emulate the kernel's second design on the CPU, for the tests only: its
per-x-column atom lists, each warp's candidates culled from them in rounds
of STAGE_ENTRIES, and a voxelizer that sums over those candidates alone.
Nothing on the card path uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

VOXEL_CHUNK = 8192  # voxels per step: bounds the [voxels, atoms] matrices
CULL_MARGIN = 0.01  # angstrom added to the kernel's culling boxes; far above f32 rounding
TILE_VOXELS = 128  # voxels of the kernel's output tile (see tile_layout)
STAGE_ENTRIES = 256  # column-list entries the kernel stages in shared memory per round
WARP = 32


def grid_coordinates(
    center: torch.Tensor,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
) -> torch.Tensor:
    """Voxel-centre world coordinates, flattened to [dim^3, 3] (x-major)."""
    idx = torch.arange(dim, dtype=torch.float32, device=center.device)
    origin = center.to(torch.float32) - resolution * (dim - 1) / 2
    ax = origin[0] + idx * resolution
    ay = origin[1] + idx * resolution
    az = origin[2] + idx * resolution
    gx, gy, gz = torch.meshgrid(ax, ay, az, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


@torch.no_grad()
def voxelize(
    positions: torch.Tensor,  # [A, 3] f32 (padded)
    features: torch.Tensor,  # [A, C] f32
    valid: torch.Tensor,  # [A] bool
    center: torch.Tensor,  # [3] f32
    *,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
    feature_radius: float = C.FEATURE_RADII,
    mask_radius: float = C.MASK_RADII,
    sigma: float = C.VOXELIZER_SIGMA,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rasterize atoms into ([D,H,W,C] f32 image, [D,H,W] bool occupancy)."""
    num_channels = features.shape[-1]
    voxels = grid_coordinates(center, resolution, dim)  # [V, 3]
    positions = positions.to(torch.float32)
    features = torch.where(valid[:, None], features.to(torch.float32), 0.0)
    penalty = torch.where(valid, 0.0, 1e30).to(torch.float32)  # [A]

    inv_two_sigma_sq = 1.0 / (2.0 * (sigma * feature_radius) ** 2)
    feature_r_sq = feature_radius * feature_radius
    mask_r_sq = mask_radius * mask_radius

    num_voxels = dim * dim * dim
    image = torch.empty((num_voxels, num_channels), dtype=torch.float32, device=positions.device)
    occupancy = torch.empty((num_voxels,), dtype=torch.bool, device=positions.device)
    for s in range(0, num_voxels, VOXEL_CHUNK):
        v = voxels[s : s + VOXEL_CHUNK]
        dx = v[:, 0:1] - positions[None, :, 0]  # [v, A]
        dy = v[:, 1:2] - positions[None, :, 1]
        dz = v[:, 2:3] - positions[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz + penalty[None, :]
        rbf = torch.where(d2 <= feature_r_sq, torch.exp(-d2 * inv_two_sigma_sq), 0.0)
        image[s : s + VOXEL_CHUNK] = rbf @ features
        occupancy[s : s + VOXEL_CHUNK] = (d2 <= mask_r_sq).any(dim=-1)
    return image.reshape(dim, dim, dim, num_channels), occupancy.reshape(dim, dim, dim)


def voxelize_numpy(
    positions: np.ndarray,
    features: np.ndarray,
    center: np.ndarray,
    *,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
    feature_radius: float = C.FEATURE_RADII,
    mask_radius: float = C.MASK_RADII,
    sigma: float = C.VOXELIZER_SIGMA,
) -> tuple[np.ndarray, np.ndarray]:
    """Direct per-atom loop in f64 (valid atoms only), for testing."""
    num_channels = features.shape[-1]
    image = np.zeros((dim, dim, dim, num_channels), dtype=np.float64)
    occupancy = np.zeros((dim, dim, dim), dtype=bool)
    origin = np.asarray(center, dtype=np.float64) - resolution * (dim - 1) / 2
    axes = origin[:, None] + np.arange(dim)[None, :] * resolution
    inv_two_sigma_sq = 1.0 / (2.0 * (sigma * feature_radius) ** 2)
    for pos, feat in zip(positions, features):
        dx2 = (axes[0] - pos[0]) ** 2
        dy2 = (axes[1] - pos[1]) ** 2
        dz2 = (axes[2] - pos[2]) ** 2
        d2 = dx2[:, None, None] + dy2[None, :, None] + dz2[None, None, :]
        rbf = np.where(d2 <= feature_radius**2, np.exp(-d2 * inv_two_sigma_sq), 0.0)
        image += rbf[..., None] * feat[None, None, None, :]
        occupancy |= d2 <= mask_radius**2
    return image.astype(np.float32), occupancy


# --------------------------------------------------------------------------
# Emulation of the CUDA kernel's binning (csrc/voxelize.cu, second design)
# --------------------------------------------------------------------------
def tile_layout(dim: int, tile_voxels: int = TILE_VOXELS) -> tuple[int, int, int, int]:
    """(rows, tiles_y, zlen, tiles_z) of the kernel's output tiles: a tile is
    `rows` y rows of `zlen` z voxels in one x slab (zlen = dim up to
    TILE_VOXELS, else one row cut into segments), so its voxels are one
    contiguous span of the [D,H,W] order. `tile_voxels` other than the
    kernel's TILE_VOXELS lets the tests cut small grids into segments."""
    zlen = min(dim, tile_voxels)
    rows = tile_voxels // zlen
    return rows, -(-dim // rows), zlen, -(-dim // zlen)


def _axes(center: torch.Tensor, resolution: float, dim: int) -> torch.Tensor:
    """[3, dim] voxel-centre coordinates per axis, as the kernel rounds them:
    (center - half) + i * res, each step in f32."""
    half = torch.tensor(resolution * (dim - 1) / 2, dtype=torch.float32)
    res = torch.tensor(resolution, dtype=torch.float32)
    idx = torch.arange(dim, dtype=torch.float32)
    return (center.to(torch.float32).cpu() - half)[:, None] + idx[None, :] * res


def _reach(feature_radius: float, mask_radius: float) -> torch.Tensor:
    return torch.tensor(max(feature_radius, mask_radius) + CULL_MARGIN, dtype=torch.float32)


def bin_atoms_reference(
    positions: torch.Tensor,  # [A, 3] f32
    valid: torch.Tensor,  # [A] bool
    center: torch.Tensor,  # [3] f32
    *,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
    feature_radius: float = C.FEATURE_RADII,
    mask_radius: float = C.MASK_RADII,
) -> list[torch.Tensor]:
    """The kernel's phase 1: per x column ix, the ascending indices of the
    valid atoms whose x lies in [vx - reach, vx + reach] (reach: the larger
    radius plus CULL_MARGIN)."""
    vx = _axes(center, resolution, dim)[0]
    reach = _reach(feature_radius, mask_radius)
    px = positions[:, 0].to(torch.float32).cpu()
    ok = valid.cpu()
    keep = ok[None, :] & (px[None, :] >= (vx - reach)[:, None]) & (px[None, :] <= (vx + reach)[:, None])
    return [torch.nonzero(row).flatten() for row in keep]


def tile_candidates_reference(
    column: torch.Tensor,  # [n] ascending atom indices of the tile's x column
    positions: torch.Tensor,
    center: torch.Tensor,
    iy0: int,
    iz0: int = 0,
    *,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
    feature_radius: float = C.FEATURE_RADII,
    mask_radius: float = C.MASK_RADII,
    stage: int = STAGE_ENTRIES,
    tile_voxels: int = TILE_VOXELS,
) -> tuple[torch.Tensor, int]:
    """The kernel's phase 2 cull for the tile at (iy0, iz0) of a slab: the
    column list is staged in rounds of `stage` entries, and each warp (32
    consecutive voxels of the tile) keeps the entries inside its box of
    voxel centres in y and z grown by the reach. Returns ([nvox, n] bool:
    entry j is a candidate of voxel v's warp, in the column's ascending
    order; the number of rounds)."""
    rows, _, zlen, _ = tile_layout(dim, tile_voxels)
    nz = min(zlen, dim - iz0)
    nvox = min(rows, dim - iy0) * nz
    axes = _axes(center, resolution, dim)
    reach = _reach(feature_radius, mask_radius)
    v0 = torch.arange(0, nvox, WARP)
    v1 = torch.clamp(v0 + WARP - 1, max=nvox - 1)
    same_row = v0 // nz == v1 // nz
    zl = iz0 + torch.where(same_row, v0 % nz, 0)
    zh = iz0 + torch.where(same_row, v1 % nz, nz - 1)
    loy, hiy = axes[1][iy0 + v0 // nz] - reach, axes[1][iy0 + v1 // nz] + reach
    loz, hiz = axes[2][zl] - reach, axes[2][zh] + reach
    pos = positions.to(torch.float32).cpu()
    parts, rounds = [], 0
    for base in range(0, len(column), stage):  # the staged rounds
        p = pos[column[base : base + stage]]
        parts.append((p[None, :, 1] >= loy[:, None]) & (p[None, :, 1] <= hiy[:, None])
                     & (p[None, :, 2] >= loz[:, None]) & (p[None, :, 2] <= hiz[:, None]))
        rounds += 1
    warp_cand = torch.cat(parts, dim=1) if parts else torch.zeros((len(v0), 0), dtype=torch.bool)
    return warp_cand.repeat_interleave(WARP, dim=0)[:nvox], rounds


@torch.no_grad()
def voxelize_binned(
    positions: torch.Tensor,
    features: torch.Tensor,
    valid: torch.Tensor,
    center: torch.Tensor,
    *,
    resolution: float = C.GRID_RESOLUTION,
    dim: int = C.GRID_DIM,
    feature_radius: float = C.FEATURE_RADII,
    mask_radius: float = C.MASK_RADII,
    sigma: float = C.VOXELIZER_SIGMA,
    stage: int = STAGE_ENTRIES,
    tile_voxels: int = TILE_VOXELS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's arithmetic summed over the kernel's binned
    candidates only (CPU): each voxel sees its warp's candidates."""
    kw = dict(resolution=resolution, dim=dim, feature_radius=feature_radius,
              mask_radius=mask_radius)
    columns = bin_atoms_reference(positions, valid, center, **kw)
    axes = _axes(center, resolution, dim)
    pos = positions.to(torch.float32).cpu()
    feats = features.to(torch.float32).cpu()
    inv_two_sigma_sq = 1.0 / (2.0 * (sigma * feature_radius) ** 2)
    rows, tiles_y, zlen, tiles_z = tile_layout(dim, tile_voxels)
    image = torch.zeros((dim, dim * dim, feats.shape[1]), dtype=torch.float32)
    occupancy = torch.zeros((dim, dim * dim), dtype=torch.bool)
    for ix in range(dim):
        column = columns[ix]
        p = pos[column]
        for iy0 in range(0, tiles_y * rows, rows):
            for iz0 in range(0, tiles_z * zlen, zlen):
                cand, _ = tile_candidates_reference(column, positions, center, iy0, iz0,
                                                    stage=stage, tile_voxels=tile_voxels, **kw)
                nz = min(zlen, dim - iz0)
                v = torch.arange(cand.shape[0])
                dx = axes[0][ix] - p[None, :, 0]
                dy = axes[1][iy0 + v // nz][:, None] - p[None, :, 1]
                dz = axes[2][iz0 + v % nz][:, None] - p[None, :, 2]
                d2 = dx * dx + dy * dy + dz * dz
                near = cand & (d2 <= feature_radius * feature_radius)
                rbf = torch.where(near, torch.exp(-d2 * inv_two_sigma_sq), 0.0)
                flat = (iy0 + v // nz) * dim + iz0 + v % nz
                image[ix, flat] = rbf @ feats[column]
                occupancy[ix, flat] = (cand & (d2 <= mask_radius * mask_radius)).any(-1)
    return image.reshape(dim, dim, dim, -1), occupancy.reshape(dim, dim, dim)
