"""Wrapper of the hand-written CUDA voxelizer (K6).

The kernels live in csrc/voxelize.cu (see its header for what they replace,
what bounds them and how the two designs differ). The source is compiled
with nvcc for sm_90a at the first launch, into `pharmaconet_tpu_torch/_build/`,
and bound with ctypes; importing this module builds nothing.

`voxelize_pallas` takes the arguments of the JAX package's
`ops/voxelize_pallas.voxelize_pallas` (there is no interpret mode) and
returns its layout: ([D,H,W,C] f32 image, [D,H,W] bool occupancy). For CPU
tensors it runs the plain torch version (ops/voxelize.py); for CUDA
tensors it launches the second design (atoms binned by x column, then one
contiguous output tile per block) or raises. The first design (one 8^3
brick per block, each culling every atom) stays launchable as
`voxelize_pallas_baseline`, which the second is held to bit for bit;
`kernel_resources` gives the registers, shared memory and blocks per SM of
both. `LAUNCHES` counts wrapper calls that launched: one per call, the
second design's binning launch included.
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
CULL_MARGIN = voxelize_ref.CULL_MARGIN  # angstrom added to the culling boxes
# the second design's tiling (csrc/voxelize.cu TILE_VOX, STAGE), which
# ops/voxelize.py emulates
TILE_VOXELS, STAGE_ENTRIES = voxelize_ref.TILE_VOXELS, voxelize_ref.STAGE_ENTRIES
RESOURCE_IDS = {"voxelize_pallas_baseline": 0, "voxelize_pallas[bin]": 1,
                "voxelize_pallas[tile]": 2}

LAUNCHES = {"voxelize_pallas": 0, "voxelize_pallas_baseline": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        lib.voxelize_binned_launch.restype = i
        lib.voxelize_binned_launch.argtypes = [vp] * 8 + [i, i, f, f, f, f, f, f, vp]
        lib.voxelize_bin_launch.restype = i  # the two phases alone (probes/probe_voxelize.py)
        lib.voxelize_bin_launch.argtypes = [vp] * 5 + [i, i, f, f, f, vp]
        lib.voxelize_tile_launch.restype = i
        lib.voxelize_tile_launch.argtypes = [vp] * 6 + [i, i, f, f, f, f, f, f, vp]
        lib.voxelize_kernel_resources.restype = i
        lib.voxelize_kernel_resources.argtypes = [i, vp]
        tiling = (ctypes.c_int * 2)()
        lib.voxelize_tiling(ctypes.cast(tiling, vp))
        if (lib.voxelize_channels(), *tiling) != (NUM_CHANNELS, TILE_VOXELS, STAGE_ENTRIES):
            raise RuntimeError(f"{path}: kernel library disagrees on its channels or tiling")
        _lib = lib
    return _lib


def _check_inputs(positions, features, valid, center) -> int:
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
    return a


def _radii(resolution, dim, feature_radius, mask_radius, sigma) -> tuple:
    """(half, fr2, mr2, inv2s2, cull) as the kernels take them."""
    return (resolution * (dim - 1) / 2, feature_radius * feature_radius,
            mask_radius * mask_radius, 1.0 / (2.0 * (sigma * feature_radius) ** 2),
            max(feature_radius, mask_radius) + CULL_MARGIN)


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
    a = _check_inputs(positions, features, valid, center)
    lib = load_library()
    dev = positions.device
    image = torch.empty((dim, dim, dim, NUM_CHANNELS), dtype=torch.float32, device=dev)
    occupancy = torch.empty((dim, dim, dim), dtype=torch.bool, device=dev)
    lists = torch.empty((dim, max(a, 1), 4), dtype=torch.float32, device=dev)  # phase 1 scratch
    counts = torch.empty((dim,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voxelize_binned_launch(
            positions.data_ptr(), features.data_ptr(), valid.data_ptr(), center.data_ptr(),
            image.data_ptr(), occupancy.data_ptr(), lists.data_ptr(), counts.data_ptr(), a,
            dim, resolution, *_radii(resolution, dim, feature_radius, mask_radius, sigma),
            stream)
    if rc != 0:
        raise RuntimeError(f"voxelize_pallas: CUDA kernel launch failed (error {rc})")
    LAUNCHES["voxelize_pallas"] += 1
    return image, occupancy


def voxelize_pallas_baseline(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's first design (one 8^3 brick per block, each culling every
    atom): the baseline the second design is held to bit for bit. No path
    calls it."""
    kw = dict(resolution=resolution, dim=dim, feature_radius=feature_radius,
              mask_radius=mask_radius, sigma=sigma)
    if _on_cpu(positions, features, valid, center):
        return voxelize_ref.voxelize(positions, features, valid, center, **kw)
    a = _check_inputs(positions, features, valid, center)
    lib = load_library()
    dev = positions.device
    image = torch.empty((dim, dim, dim, NUM_CHANNELS), dtype=torch.float32, device=dev)
    occupancy = torch.empty((dim, dim, dim), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.voxelize_launch(
            positions.data_ptr(), features.data_ptr(), valid.data_ptr(), center.data_ptr(),
            image.data_ptr(), occupancy.data_ptr(), a, dim, resolution,
            *_radii(resolution, dim, feature_radius, mask_radius, sigma), stream)
    if rc != 0:
        raise RuntimeError(f"voxelize_pallas_baseline: CUDA kernel launch failed (error {rc})")
    LAUNCHES["voxelize_pallas_baseline"] += 1
    return image, occupancy


def kernel_resources(name: str, device: torch.device | None = None) -> dict:
    """Registers and local (spill) bytes per thread, shared memory per
    block and resident blocks per SM of a K6 kernel (RESOURCE_IDS: the
    first design, the second's binning and tile kernels) on the card."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device or torch.device("cuda", torch.cuda.current_device())):
        rc = lib.voxelize_kernel_resources(RESOURCE_IDS[name], ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name}: resource query failed (error {rc})")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))
