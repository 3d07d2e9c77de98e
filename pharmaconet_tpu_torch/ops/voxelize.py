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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

VOXEL_CHUNK = 8192  # voxels per step: bounds the [voxels, atoms] matrices


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
