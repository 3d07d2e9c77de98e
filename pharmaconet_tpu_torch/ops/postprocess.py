"""Density-map post-processing on the device: Gaussian smoothing, masking
and thresholding of the mask head's logits, and the sparse compaction of
the thresholded maps for the host.

    unavailable = NOT(box_area AND protein_mask AND cavity_narrow)
    density = sigmoid(logits); density[unavailable] = 0
    density = gaussian_smooth_5x5x5(density, sigma=0.5, zero-pad)
    density[unavailable] = 0; density[density < 0.5] = 0

The same arithmetic and order of operations as the JAX package's
`ops/postprocess.py`; the 5^3 Gaussian runs as three 5-tap 1-D passes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C


def gaussian_kernel_1d(kernel_size: int = 5, sigma: float = 0.5) -> np.ndarray:
    mean = (kernel_size - 1) / 2
    x = np.arange(kernel_size, dtype=np.float64)
    k = np.exp(-(((x - mean) / sigma) ** 2) / 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth(maps: torch.Tensor, kernel_size: int = 5, sigma: float = 0.5) -> torch.Tensor:
    """Separable 3-D Gaussian smoothing with zero padding: [K, D, H, W] ->
    [K, D, H, W]. Each 1-D pass sums the taps in order, as the JAX package."""
    kernel = gaussian_kernel_1d(kernel_size, sigma)
    pad = kernel_size // 2
    out = maps
    for axis in (1, 2, 3):
        moved = out.movedim(axis, -1)
        padded = F.pad(moved, (pad, pad))
        n = moved.shape[-1]
        acc = None
        for i in range(kernel_size):
            term = padded[..., i : i + n] * float(kernel[i])
            acc = term if acc is None else acc + term
        out = acc.movedim(-1, axis)
    return out


def box_area_mask(tokens: torch.Tensor, dim: int = C.GRID_DIM) -> torch.Tensor:
    """Per-token spherical mask [K, dim, dim, dim]: voxel distance to the
    token < ceil((dist + 1.0) / 0.5) voxels, compared on f32 squares."""
    radii = torch.tensor([C.box_radius_voxels(t) for t in range(C.NUM_INTERACTION_TYPES)],
                         dtype=torch.float32, device=tokens.device)
    axes = torch.arange(dim, dtype=torch.float32, device=tokens.device)
    t = tokens.to(torch.float32)
    dx = (axes[None, :] - t[:, 0:1]) ** 2  # [K, dim]
    dy = (axes[None, :] - t[:, 1:2]) ** 2
    dz = (axes[None, :] - t[:, 2:3]) ** 2
    d2 = dx[:, :, None, None] + dy[:, None, :, None] + dz[:, None, None, :]
    r2 = radii[tokens[:, 3].long()] ** 2
    return d2 < r2[:, None, None, None]


def postprocess_density(
    logits: torch.Tensor,  # [K, D, H, W] mask-head logits
    tokens: torch.Tensor,  # [K, 4]
    protein_mask: torch.Tensor,  # [D, H, W] bool (True = empty space)
    cavity_narrow: torch.Tensor,  # [D, H, W] bool
    box_threshold: float = C.DEFAULT_BOX_THRESHOLD,
) -> torch.Tensor:
    """Masked + smoothed + thresholded density maps [K, D, H, W]."""
    available = box_area_mask(tokens, dim=logits.shape[-1]) & (protein_mask & cavity_narrow)[None]
    density = torch.where(available, torch.sigmoid(logits), 0.0)
    density = torch.where(available, gaussian_smooth(density), 0.0)
    return torch.where(density >= box_threshold, density, 0.0)


def sparse_compact(density: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nonzero compaction of post-threshold maps [K, ...] for the sparse
    density wire: (vals [K, cap] f32, idxs [K, cap] i32 flat indices in
    ascending order, counts [K] i32). Lanes past a map's count hold 0;
    counts > cap mark maps the caller pulls densely."""
    k = density.shape[0]
    flat = density.reshape(k, -1)
    nz = flat > 0.0
    counts = nz.sum(dim=1, dtype=torch.int32)
    rows, cols = torch.nonzero(nz, as_tuple=True)  # row-major: ascending per map
    starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts.long()
    lane = torch.arange(rows.numel(), device=density.device) - starts[rows]
    keep = lane < cap
    vals = torch.zeros((k, cap), dtype=torch.float32, device=density.device)
    idxs = torch.zeros((k, cap), dtype=torch.int32, device=density.device)
    rows, cols, lane = rows[keep], cols[keep], lane[keep]
    vals[rows, lane] = flat[rows, cols]
    idxs[rows, lane] = cols.to(torch.int32)
    return vals, idxs, counts
