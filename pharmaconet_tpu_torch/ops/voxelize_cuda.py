"""Wrapper of the hand-written CUDA voxelizer (K6).

The kernel lives in csrc/voxelize.cu (see its header for what it replaces
and what bounds it). The source is compiled with nvcc for sm_90a at the
first launch, into `pharmaconet_tpu_torch/_build/`, and bound with ctypes;
importing this module builds nothing.

`voxelize_pallas` takes the arguments of the JAX package's
`ops/voxelize_pallas.voxelize_pallas` (there is no interpret mode) and
returns its layout: ([D,H,W,C] f32 image, [D,H,W] bool occupancy). For CPU
tensors it runs the plain torch version (ops/voxelize.py); for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import constants as C
from . import voxelize as voxelize_ref
from .screen_cuda import NVCC_FLAGS, _on_cpu, nvcc_path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "voxelize.cu"
NUM_CHANNELS = C.NUM_PROTEIN_CHANNELS  # the kernel's compiled channel count
CULL_MARGIN = 0.01  # angstrom added to the culling box; far above f32 rounding

LAUNCHES = {"voxelize_pallas": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    LAUNCHES["voxelize_pallas"] = 0


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the voxelizer library."""
    global _lib
    if _lib is None:
        from ..native import build_shared

        path = build_shared("voxelize", [SOURCE], [nvcc_path()], NVCC_FLAGS, timeout=900)
        lib = ctypes.CDLL(str(path))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.voxelize_launch.restype = i
        lib.voxelize_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, f, f, f, f, f, f, vp]
        lib.voxelize_channels.restype = i
        if lib.voxelize_channels() != NUM_CHANNELS:
            raise RuntimeError(f"{path}: kernel library disagrees on its channel count")
        _lib = lib
    return _lib


def voxelize_pallas(
    positions: torch.Tensor,  # [A, 3] f32
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
    """K6: rasterize atoms into ([D,H,W,C] image, [D,H,W] occupancy)."""
    kw = dict(resolution=resolution, dim=dim, feature_radius=feature_radius,
              mask_radius=mask_radius, sigma=sigma)
    if _on_cpu(positions, features, valid, center):
        return voxelize_ref.voxelize(positions, features, valid, center, **kw)
    a = positions.shape[0]
    for name, t, dtype, shape in (
        ("positions", positions, torch.float32, (a, 3)),
        ("features", features, torch.float32, (a, NUM_CHANNELS)),
        ("valid", valid, torch.bool, (a,)),
        ("center", center, torch.float32, (3,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    lib = load_library()
    dev = positions.device
    image = torch.empty((dim, dim, dim, NUM_CHANNELS), dtype=torch.float32, device=dev)
    occupancy = torch.empty((dim, dim, dim), dtype=torch.bool, device=dev)
    inv2s2 = 1.0 / (2.0 * (sigma * feature_radius) ** 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voxelize_launch(
            positions.data_ptr(), features.data_ptr(), valid.data_ptr(), center.data_ptr(),
            image.data_ptr(), occupancy.data_ptr(), a, dim, resolution,
            resolution * (dim - 1) / 2, feature_radius * feature_radius,
            mask_radius * mask_radius, inv2s2,
            max(feature_radius, mask_radius) + CULL_MARGIN, stream)
    if rc != 0:
        raise RuntimeError(f"voxelize_pallas: CUDA kernel launch failed (error {rc})")
    LAUNCHES["voxelize_pallas"] += 1
    return image, occupancy
