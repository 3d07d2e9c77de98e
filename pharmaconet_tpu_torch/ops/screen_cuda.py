"""Wrappers of the hand-written CUDA screening kernels (K1, K4, K5).

The kernels live in csrc/screen_fused.cu (see its header for what each
replaces and what bounds it). The source is compiled with nvcc for sm_90a
at the first launch, into `pharmaconet_tpu_torch/_build/`, and bound with
ctypes; importing this module builds nothing.

Each wrapper takes its plain torch version (ops/screen_ref.py) for tensors
on the CPU. For CUDA tensors it launches the kernel on the current stream
of the tensors' device, or raises: a failed build or launch is never
turned into a call to the plain version. `LAUNCHES` counts kernel
launches, one per launch, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import torch

from ..scoring.screen_tiles import NODE_CAP, TILE
from . import screen_ref

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "screen_fused.cu"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
BLOCK_P = 8
MAX_CONFORMERS = 8

LAUNCHES = {"score_tiles_fused_rows": 0, "score_blocks_fused": 0, "gaussian_phase": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA screening kernels cannot be built")
    return found


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        from ..native import build_shared

        path = build_shared("screen_fused", [SOURCE], [nvcc_path()], NVCC_FLAGS,
                            timeout=900)
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.screen_tiles_fused.restype = i
        lib.screen_tiles_fused.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.screen_blocks_fused.restype = i
        lib.screen_blocks_fused.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.screen_gauss_phase.restype = i
        lib.screen_gauss_phase.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp]
        lib.screen_max_conformers.restype = i
        if lib.screen_max_conformers() != MAX_CONFORMERS:
            raise RuntimeError(f"{path}: kernel library disagrees on the conformer limit")
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on one CUDA device (kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"screening tensors span several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"screening kernels run on cuda or cpu tensors, not {dev}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _conformers(pos_blocks: torch.Tensor) -> tuple[int, int]:
    if pos_blocks.dim() != 3 or pos_blocks.shape[1] % 3 or pos_blocks.shape[2] != NODE_CAP:
        raise ValueError(f"pos_blocks must be [T, 3C, {NODE_CAP}], got {tuple(pos_blocks.shape)}")
    t, c = pos_blocks.shape[0], pos_blocks.shape[1] // 3
    if not 1 <= c <= MAX_CONFORMERS:
        raise ValueError(
            f"{c} conformers per ligand; the CUDA screening kernels take 1..{MAX_CONFORMERS}"
        )
    return t, c


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Launch `fn` on the device's current stream (tensors pass as their
    data pointers); raises on a launch error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")
    LAUNCHES[name] += 1


def score_tiles_fused_rows(
    pos_blocks: torch.Tensor,  # [T, 3C, NODE_CAP] f32
    uv: torch.Tensor,  # [T, TILE] i32
    gtab: torch.Tensor,  # [T, 3, P, TILE] f32
    aux: torch.Tensor,  # [T, 7, TILE] f32
    depth1: int,
    depth2: int,
) -> torch.Tensor:
    """K1: the fused screening kernel over the tile-major layout. Returns
    the expanded table as [T*TILE, C] rows (scores at pair-end rows, -1
    on failed cross pairs)."""
    if _on_cpu(pos_blocks, uv, gtab, aux):
        return screen_ref.score_tiles_fused_rows(pos_blocks, uv, gtab, aux, depth1, depth2)
    t, c = _conformers(pos_blocks)
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv", uv, torch.int32, (t, TILE))
    _check("gtab", gtab, torch.float32, (t, 3, BLOCK_P, TILE))
    _check("aux", aux, torch.float32, (t, 7, TILE))
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=pos_blocks.device)
    _launch("score_tiles_fused_rows", pos_blocks.device, lib.screen_tiles_fused,
            pos_blocks, uv, gtab, aux, out, t, c, int(depth1), int(depth2))
    return out


def score_blocks_fused(
    pos_blocks: torch.Tensor,  # [T, 3C, NODE_CAP] f32
    uv_packed: torch.Tensor,  # [1, NS] i32
    muT: torch.Tensor,  # [P, NS] f32
    invT: torch.Tensor,
    winvT: torch.Tensor,
    flags_block: torch.Tensor,  # seven [NS] f32 rows
    flags_pair: torch.Tensor,
    end_mn_inv: torch.Tensor,
    end_mn_half: torch.Tensor,
    end_fail_gate: torch.Tensor,
    thr_ns: torch.Tensor,
    self_ns: torch.Tensor,
    depth1: int,
    depth2: int,
) -> torch.Tensor:
    """K4: K1's arithmetic over the row layout. Returns the expanded
    [C, NS] table."""
    rows = (flags_block, flags_pair, end_mn_inv, end_mn_half, end_fail_gate,
            thr_ns, self_ns)
    if _on_cpu(pos_blocks, uv_packed, muT, invT, winvT, *rows):
        return screen_ref.score_blocks_fused(
            pos_blocks, uv_packed, muT, invT, winvT, *rows, depth1, depth2
        )
    t, c = _conformers(pos_blocks)
    ns = t * TILE
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv_packed", uv_packed, torch.int32, (1, ns))
    for name, a in (("muT", muT), ("invT", invT), ("winvT", winvT)):
        _check(name, a, torch.float32, (BLOCK_P, ns))
    for k, a in enumerate(rows):
        _check(f"row {k}", a, torch.float32, (ns,))
    lib = load_library()
    out = torch.empty((c, ns), dtype=torch.float32, device=pos_blocks.device)
    row_ptrs = (ctypes.c_void_p * 7)(*(a.data_ptr() for a in rows))
    _launch("score_blocks_fused", pos_blocks.device, lib.screen_blocks_fused,
            pos_blocks, uv_packed, muT, invT, winvT,
            ctypes.cast(row_ptrs, ctypes.c_void_p), out, t, c, int(depth1), int(depth2))
    return out


def gaussian_phase(
    pos_blocks: torch.Tensor,  # [T, 3C, NODE_CAP] f32
    uv_packed: torch.Tensor,  # [1, NS] i32
    muT: torch.Tensor,  # [P, NS] f32
    invT: torch.Tensor,
    winvT: torch.Tensor,
) -> torch.Tensor:
    """K5: the Gaussian phase alone. Returns stacked [2C, NS]: rows
    [0, C) scores, [C, 2C) pass counts."""
    if _on_cpu(pos_blocks, uv_packed, muT, invT, winvT):
        return screen_ref.gaussian_phase(pos_blocks, uv_packed, muT, invT, winvT)
    t, c = _conformers(pos_blocks)
    ns = t * TILE
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv_packed", uv_packed, torch.int32, (1, ns))
    for name, a in (("muT", muT), ("invT", invT), ("winvT", winvT)):
        _check(name, a, torch.float32, (BLOCK_P, ns))
    lib = load_library()
    out = torch.empty((2 * c, ns), dtype=torch.float32, device=pos_blocks.device)
    _launch("gaussian_phase", pos_blocks.device, lib.screen_gauss_phase,
            pos_blocks, uv_packed, muT, invT, winvT, out, t, c)
    return out
