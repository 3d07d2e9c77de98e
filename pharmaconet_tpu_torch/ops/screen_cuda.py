"""Wrappers of the hand-written CUDA screening kernels (K1-K5) and of the
probe kernels (P1-P4).

The kernels live in csrc/screen_fused.cu (see its header for what each
replaces and what bounds it). The source is compiled with nvcc for sm_90a
at the first launch, into `pharmaconet_tpu_torch/_build/`, and bound with
ctypes; importing this module builds nothing.

Each wrapper takes its plain torch version (ops/screen_ref.py) for tensors
on the CPU. For CUDA tensors it launches the kernel on the current stream
of the tensors' device, or raises: a failed build or launch is never
turned into a call to the plain version. `LAUNCHES` counts kernel
launches, one per launch, so a run can show that its path went through the
kernels; `MODE_LAUNCHES` splits the counts of P3 and P4 by mode
("score_tiles_fused_ablation[noscan]", ...). K2's first design stays
launchable as `score_tiles_v3_baseline_rows` (K1's is P3's `full`) and P4
ohbf16's as `score_tiles_ohbf16_baseline`, so that chip_smoke.py and the
GPU tests can hold K1, K2 and P4 ohbf16 to them bit for bit;
`kernel_resources` gives the registers, shared memory and blocks per SM of
both designs.

The kernels are instantiated for 1..MAX_CONFORMERS conformers. K1-K5 take
any count all the same: every conformer column is independent through the
Gaussian phase, both bounded scans and the fail gates (the JAX package's
`_gauss_phase` sums the distance over the 3 axes of one conformer,
`_gauss_phase_dt` sums over model pairs, not conformers, and
`_scan_bounded_tile` / `_scan_fail_tail` work row by row with [1, tile]
flags shared by every row), so above the cap the wrappers launch once per
group of at most MAX_CONFORMERS columns (`conformer_groups`) and join the
outputs (`by_conformer_groups`). The probe kernels P1-P4 keep the cap.
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
MAX_SMEM = 232448  # bytes of shared memory one block may use on sm_90

ABLATION_FLAGS = {"full": 0, "noscan": 1, "noexp": 2, "nohot": 4, "gauss0": 7}  # P3
VARIANT_IDS = {"full": 0, "b4d": 1, "ohbf16": 2}  # P4

LAUNCHES = {"score_tiles_fused_rows": 0, "score_tiles_v3": 0, "score_tiles_fused_dt": 0,
            "score_blocks_fused": 0, "gaussian_phase": 0, "gaussian_phase_gather": 0,
            "gaussian_phase_local": 0, "score_tiles_fused_ablation": 0,
            "score_tiles_fused_variant": 0, "score_tiles_v3_baseline": 0,
            "score_tiles_ohbf16_baseline": 0}
# kernel ids of screen_kernel_resources: K1, K1's first design (P3 `full`),
# K2, K2's first design, P4 ohbf16, its first design
RESOURCE_IDS = {"score_tiles_fused_rows": 0, "score_tiles_fused_ablation[full]": 1,
                "score_tiles_v3": 2, "score_tiles_v3_baseline": 3,
                "score_tiles_fused_variant[ohbf16]": 4, "score_tiles_ohbf16_baseline": 5}
MODE_LAUNCHES = {
    **{f"score_tiles_fused_ablation[{m}]": 0 for m in ABLATION_FLAGS},
    **{f"score_tiles_fused_variant[{m}]": 0 for m in VARIANT_IDS},
}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, MODE_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
        lib.screen_tiles_fused_dt.restype = i
        lib.screen_tiles_fused_dt.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.screen_tiles_v3.restype = i
        lib.screen_tiles_v3.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.screen_tiles_v3_baseline.restype = i
        lib.screen_tiles_v3_baseline.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.screen_kernel_resources.restype = i
        lib.screen_kernel_resources.argtypes = [i, i, i, i, vp]
        lib.screen_gauss_gather.restype = i
        lib.screen_gauss_gather.argtypes = [vp, ctypes.c_longlong, vp, vp, vp, vp, vp, i, i, vp]
        lib.screen_gauss_local.restype = i
        lib.screen_gauss_local.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, vp]
        lib.screen_tiles_fused_ablation.restype = i
        lib.screen_tiles_fused_ablation.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.screen_tiles_fused_variant.restype = i
        lib.screen_tiles_fused_variant.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.screen_tiles_ohbf16_baseline.restype = i
        lib.screen_tiles_ohbf16_baseline.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
        lib.screen_max_conformers.restype = i
        lib.screen_max_smem.restype = i
        if (lib.screen_max_conformers(), lib.screen_max_smem()) != (MAX_CONFORMERS, MAX_SMEM):
            raise RuntimeError(f"{path}: kernel library disagrees on its limits")
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on one CUDA device (kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel arguments span several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu tensors, not {dev}")
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
    return _conformer_count(pos_blocks.shape[0], pos_blocks.shape[1] // 3)


def _dt_conformers(dt: torch.Tensor) -> tuple[int, int]:
    if dt.dim() != 3 or dt.shape[2] != TILE:
        raise ValueError(f"dt must be [T, C, {TILE}], got {tuple(dt.shape)}")
    return _conformer_count(dt.shape[0], dt.shape[1])


def _conformer_count(t: int, c: int) -> tuple[int, int]:
    if not 1 <= c <= MAX_CONFORMERS:
        raise ValueError(
            f"{c} conformers per ligand; one launch of a CUDA screening kernel takes "
            f"1..{MAX_CONFORMERS}"
        )
    return t, c


def conformer_groups(c: int, cap: int = MAX_CONFORMERS) -> list[tuple[int, int]]:
    """[c0, c1) column ranges that cover c conformers in the fewest groups
    of at most `cap`, of sizes that differ by at most one."""
    n = -(-c // cap)
    bounds = [k * c // n for k in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def by_conformer_groups(fn, x: torch.Tensor, per: int, out_dim: int, stacked: bool = False,
                        cap: int = MAX_CONFORMERS) -> torch.Tensor:
    """`fn` over groups of at most `cap` conformers, joined: x carries `per`
    rows of dim 1 per conformer (3 for node tables, 1 for distances); each
    group's slice is copied out contiguous (a fresh allocation, so TMA's
    16-byte alignment holds). The outputs join along `out_dim`; `stacked`
    outputs ([2c, NS]: scores, then pass counts) join half by half."""
    outs = [fn(x[:, per * c0 : per * c1].contiguous()) for c0, c1 in
            conformer_groups(x.shape[1] // per, cap)]
    if stacked:
        outs = [o[: o.shape[0] // 2] for o in outs] + [o[o.shape[0] // 2 :] for o in outs]
    return torch.cat(outs, out_dim)


def _grouped(x: torch.Tensor, per: int) -> bool:
    """True when x carries more conformers than one launch takes."""
    return x.dim() == 3 and x.shape[1] // per > MAX_CONFORMERS


def _tile_major(pos_blocks, uv, gtab, aux) -> tuple[int, int]:
    """(T, C) of K1's tile-major inputs, checked."""
    t, c = _conformers(pos_blocks)
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv", uv, torch.int32, (t, TILE))
    _check("gtab", gtab, torch.float32, (t, 3, BLOCK_P, TILE))
    _check("aux", aux, torch.float32, (t, 7, TILE))
    return t, c


def _check_aligned(**tensors: torch.Tensor) -> None:
    """K1 and K2 stage their per-tile tables by TMA, which copies 16-byte
    units from 16-byte aligned addresses."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it in 16-byte units from a 16-byte "
                             f"aligned address, not {t.data_ptr():#x}")


def _row_tables(ns: int, muT, invT, winvT) -> None:
    """Checks the row layout's Gaussian tables [P, NS], NS whole tiles."""
    if ns % TILE:
        raise ValueError(f"the row count {ns} is not a multiple of TILE {TILE}")
    for name, a in (("muT", muT), ("invT", invT), ("winvT", winvT)):
        _check(name, a, torch.float32, (BLOCK_P, ns))


def _launch(name: str, device: torch.device, fn, *args, mode: str | None = None) -> None:
    """Launch `fn` on the device's current stream (tensors pass as their
    data pointers, None as a null pointer); raises on a launch error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")
    LAUNCHES[name] += 1
    if mode is not None:
        MODE_LAUNCHES[f"{name}[{mode}]"] += 1


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
    if _grouped(pos_blocks, 3):
        return by_conformer_groups(
            lambda p: score_tiles_fused_rows(p, uv, gtab, aux, depth1, depth2), pos_blocks, 3, 1)
    t, c = _tile_major(pos_blocks, uv, gtab, aux)
    _check_aligned(pos_blocks=pos_blocks, uv=uv)
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=pos_blocks.device)
    if t:
        _launch("score_tiles_fused_rows", pos_blocks.device, lib.screen_tiles_fused,
                pos_blocks, uv, gtab, aux, out, t, c, int(depth1), int(depth2))
    return out


def score_tiles_fused_dt_rows(
    dt: torch.Tensor,  # [T, C, TILE] f32 stored conformer distances
    gtab: torch.Tensor,  # [T, 3, P, TILE] f32
    aux: torch.Tensor,  # [T, 7, TILE] f32
    depth1: int,
    depth2: int,
) -> torch.Tensor:
    """K3: K1 with the distances of a v2 tile store. Returns [T*TILE, C]
    rows (scores at pair-end rows, -1 on failed cross pairs)."""
    if _on_cpu(dt, gtab, aux):
        return screen_ref.score_tiles_fused_dt_rows(dt, gtab, aux, depth1, depth2)
    if _grouped(dt, 1):
        return by_conformer_groups(
            lambda d: score_tiles_fused_dt_rows(d, gtab, aux, depth1, depth2), dt, 1, 1)
    t, c = _dt_conformers(dt)
    _check("dt", dt, torch.float32, (t, c, TILE))
    _check("gtab", gtab, torch.float32, (t, 3, BLOCK_P, TILE))
    _check("aux", aux, torch.float32, (t, 7, TILE))
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=dt.device)
    _launch("score_tiles_fused_dt", dt.device, lib.screen_tiles_fused_dt,
            dt, gtab, aux, out, t, c, int(depth1), int(depth2))
    return out


def _v3_layout_bytes(c: int, g_cap: int, r_pad: int, stages: int) -> int:
    """K2's shared memory with `stages` buffers (csrc v3_layout): two
    mbarriers, then per stage the group table's entry limits, the tile's
    gid, its [g_cap, r_pad] table and a scan buffer."""
    limits = -(-4 * stages * g_cap // 16) * 16
    return 16 + limits + 4 * stages * (TILE + g_cap * r_pad + (2 * c + 1) * TILE)


def v3_shared_bytes(c: int, g_cap: int, r_pad: int) -> int:
    """Shared memory one K2 block needs: double buffers where they fit a
    block, else single ones (as the kernel chooses). Raises when neither
    fits (g_cap grows when one pair references many groups)."""
    for stages in (2, 1):
        smem = _v3_layout_bytes(c, g_cap, r_pad, stages)
        if smem <= MAX_SMEM:
            return smem
    raise ValueError(
        f"score_tiles_v3: a [{g_cap}, {r_pad}] group table with {c} conformers "
        f"needs {smem} bytes of shared memory per block; the card allows {MAX_SMEM}"
    )


def score_tiles_v3_rows(
    dt: torch.Tensor,  # [T, C, TILE] f32 per-block conformer distances
    gid: torch.Tensor,  # [T, TILE] i32 group slot of each row
    tab: torch.Tensor,  # [T, G, R] f32 per-tile group tables
    aux: torch.Tensor,  # [T, 3, TILE] f32 (pair-start flag, thr, is_self)
    depth: int,
    mn_cap: int,
) -> torch.Tensor:
    """K2: the v3 block-major kernel. Returns [T*TILE, C] rows (scores at
    pair-end rows, -1 on failed cross pairs). The tile's group table is
    staged in shared memory; a table too large for one block raises."""
    if _on_cpu(dt, gid, tab, aux):
        return screen_ref.score_tiles_v3_rows(dt, gid, tab, aux, depth, mn_cap)
    if _grouped(dt, 1):
        return by_conformer_groups(
            lambda d: score_tiles_v3_rows(d, gid, tab, aux, depth, mn_cap), dt, 1, 1)
    t, c, g_cap, r_pad = _v3_inputs(dt, gid, tab, aux, mn_cap)
    v3_shared_bytes(c, g_cap, r_pad)
    if g_cap * r_pad % 4:
        raise ValueError(f"score_tiles_v3: a [{g_cap}, {r_pad}] group table is not a whole "
                         "number of 16-byte units (the kernel stages it by TMA)")
    _check_aligned(gid=gid, tab=tab)
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=dt.device)
    if t:
        _launch("score_tiles_v3", dt.device, lib.screen_tiles_v3, dt, gid, tab, aux, out,
                t, c, g_cap, r_pad, int(mn_cap), int(depth))
    return out


def _v3_inputs(dt, gid, tab, aux, mn_cap: int) -> tuple[int, int, int, int]:
    """(T, C, g_cap, r_pad) of K2's inputs, checked."""
    t, c = _dt_conformers(dt)
    if tab.dim() != 3 or tab.shape[0] != t or tab.shape[2] < 3 * mn_cap + 1:
        raise ValueError(f"tab must be [{t}, G, R >= {3 * mn_cap + 1}], got {tuple(tab.shape)}")
    g_cap, r_pad = tab.shape[1], tab.shape[2]
    _check("dt", dt, torch.float32, (t, c, TILE))
    _check("gid", gid, torch.int32, (t, TILE))
    _check("tab", tab, torch.float32, (t, g_cap, r_pad))
    _check("aux", aux, torch.float32, (t, 3, TILE))
    return t, c, g_cap, r_pad


def score_tiles_v3_baseline_rows(
    dt: torch.Tensor, gid: torch.Tensor, tab: torch.Tensor, aux: torch.Tensor,
    depth: int, mn_cap: int,
) -> torch.Tensor:
    """K2's first design (one block per tile, the group table staged behind
    a barrier, every mn_cap entry evaluated, a block-wide scan): the
    baseline that K2 is held to bit for bit. No route calls it."""
    if _on_cpu(dt, gid, tab, aux):
        return screen_ref.score_tiles_v3_rows(dt, gid, tab, aux, depth, mn_cap)
    if _grouped(dt, 1):
        return by_conformer_groups(
            lambda d: score_tiles_v3_baseline_rows(d, gid, tab, aux, depth, mn_cap), dt, 1, 1)
    t, c, g_cap, r_pad = _v3_inputs(dt, gid, tab, aux, mn_cap)
    smem = 4 * (g_cap * r_pad + (2 * c + 1) * TILE)
    if smem > MAX_SMEM:
        raise ValueError(f"score_tiles_v3_baseline: {smem} bytes of shared memory per block; "
                         f"the card allows {MAX_SMEM}")
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=dt.device)
    if t:
        _launch("score_tiles_v3_baseline", dt.device, lib.screen_tiles_v3_baseline, dt, gid,
                tab, aux, out, t, c, g_cap, r_pad, int(mn_cap), int(depth))
    return out


def kernel_resources(name: str, c: int, g_cap: int = 16, r_pad: int = 128,
                     device: torch.device | None = None) -> dict:
    """Registers and local (spill) bytes per thread, dynamic shared memory
    per block and resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of K1, K2, P4 ohbf16
    or their first designs (RESOURCE_IDS) at `c` conformers, K2 at a
    [g_cap, r_pad] group table, on the card."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device or torch.device("cuda", torch.cuda.current_device())):
        rc = lib.screen_kernel_resources(RESOURCE_IDS[name], c, g_cap, r_pad,
                                         ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{name}: resource query failed (error {rc})")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"), out))


def score_tiles_v3_pairs(
    dt: torch.Tensor,
    gid: torch.Tensor,
    tab: torch.Tensor,
    aux: torch.Tensor,
    ends: torch.Tensor,  # [NPpad] pair-end rows, clipped to >= 0
    depth: int,
    mn_cap: int,
) -> torch.Tensor:
    """K2 + pair compaction on the device: the [NPpad, C] rows of K2's
    output at the pair-end rows (one index_select after the kernel, where
    the JAX package gathers with jnp.take after its Pallas call)."""
    rows = score_tiles_v3_rows(dt, gid, tab, aux, depth, mn_cap)
    return rows.index_select(0, ends.long())


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
    if _grouped(pos_blocks, 3):
        return by_conformer_groups(
            lambda p: score_blocks_fused(p, uv_packed, muT, invT, winvT, *rows, depth1, depth2),
            pos_blocks, 3, 0)
    t, c = _conformers(pos_blocks)
    ns = t * TILE
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv_packed", uv_packed, torch.int32, (1, ns))
    _row_tables(ns, muT, invT, winvT)
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
    if _grouped(pos_blocks, 3):
        return by_conformer_groups(
            lambda p: gaussian_phase(p, uv_packed, muT, invT, winvT), pos_blocks, 3, 0,
            stacked=True)
    t, c = _conformers(pos_blocks)
    ns = t * TILE
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("uv_packed", uv_packed, torch.int32, (1, ns))
    _row_tables(ns, muT, invT, winvT)
    lib = load_library()
    out = torch.empty((2 * c, ns), dtype=torch.float32, device=pos_blocks.device)
    _launch("gaussian_phase", pos_blocks.device, lib.screen_gauss_phase,
            pos_blocks, uv_packed, muT, invT, winvT, out, t, c)
    return out


# --------------------------------------------------------------------------
# Probe kernels P1-P4 (measurement variants of K1 and K5; see
# pharmaconet_tpu_torch/probes/)
# --------------------------------------------------------------------------
def gaussian_phase_gather(
    d_table: torch.Tensor,  # [NU, C] f32 unique conformer distances
    slots: torch.Tensor,  # [NS] i32 row -> d_table row
    muT: torch.Tensor,  # [P, NS] f32
    invT: torch.Tensor,
    winvT: torch.Tensor,
) -> torch.Tensor:
    """P1: the Gaussian phase with each row's distances gathered from
    d_table by slot. Returns stacked [2C, NS] (scores, then pass counts).
    A slot outside the table gives NaN scores on the card."""
    if _on_cpu(d_table, slots, muT, invT, winvT):
        return screen_ref.gaussian_phase_gather(d_table, slots, muT, invT, winvT)
    if d_table.dim() != 2:
        raise ValueError(f"d_table must be [NU, C], got {tuple(d_table.shape)}")
    nu, c = _conformer_count(*d_table.shape)
    ns = slots.shape[0]
    _check("d_table", d_table, torch.float32, (nu, c))
    _check("slots", slots, torch.int32, (ns,))
    _row_tables(ns, muT, invT, winvT)
    lib = load_library()
    out = torch.empty((2 * c, ns), dtype=torch.float32, device=d_table.device)
    _launch("gaussian_phase_gather", d_table.device, lib.screen_gauss_gather,
            d_table, nu, slots, muT, invT, winvT, out, ns // TILE, c)
    return out


def gaussian_phase_local(
    pos_blocks: torch.Tensor,  # [T, 3C, NODE_CAP] f32
    u_loc: torch.Tensor,  # [NS] i32 local node slot of each row's u
    v_loc: torch.Tensor,  # [NS] i32
    muT: torch.Tensor,  # [P, NS] f32
    invT: torch.Tensor,
    winvT: torch.Tensor,
) -> torch.Tensor:
    """P2: the Gaussian phase with the distances rebuilt from per-tile node
    tables, u and v from two index rows. Returns stacked [2C, NS]."""
    if _on_cpu(pos_blocks, u_loc, v_loc, muT, invT, winvT):
        return screen_ref.gaussian_phase_local(pos_blocks, u_loc, v_loc, muT, invT, winvT)
    t, c = _conformers(pos_blocks)
    ns = t * TILE
    _check("pos_blocks", pos_blocks, torch.float32, (t, 3 * c, NODE_CAP))
    _check("u_loc", u_loc, torch.int32, (ns,))
    _check("v_loc", v_loc, torch.int32, (ns,))
    _row_tables(ns, muT, invT, winvT)
    lib = load_library()
    out = torch.empty((2 * c, ns), dtype=torch.float32, device=pos_blocks.device)
    _launch("gaussian_phase_local", pos_blocks.device, lib.screen_gauss_local,
            pos_blocks, u_loc, v_loc, muT, invT, winvT, out, t, c)
    return out


def score_tiles_fused_ablation(
    pos_blocks: torch.Tensor,  # K1's inputs
    uv: torch.Tensor,
    gtab: torch.Tensor,
    aux: torch.Tensor,
    depth1: int,
    depth2: int,
    mode: str,
) -> torch.Tensor:
    """P3: K1 with one stage removed (`full`, `noscan`, `noexp`, `nohot`,
    `gauss0`; see screen_ref.score_tiles_fused_ablation). Returns
    [T*TILE, C] rows; `full` launches K1's own instantiation."""
    if mode not in ABLATION_FLAGS:
        raise ValueError(f"unknown ablation {mode!r}; expected one of {tuple(ABLATION_FLAGS)}")
    if _on_cpu(pos_blocks, uv, gtab, aux):
        return screen_ref.score_tiles_fused_ablation(pos_blocks, uv, gtab, aux, depth1,
                                                     depth2, mode)
    t, c = _tile_major(pos_blocks, uv, gtab, aux)
    lib = load_library()
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=pos_blocks.device)
    _launch("score_tiles_fused_ablation", pos_blocks.device, lib.screen_tiles_fused_ablation,
            pos_blocks, uv, gtab, aux, out, t, c, int(depth1), int(depth2),
            ABLATION_FLAGS[mode], mode=mode)
    return out


def score_tiles_fused_variant(
    pos_blocks: torch.Tensor,  # K1's inputs
    uv: torch.Tensor,
    gtab: torch.Tensor,
    aux: torch.Tensor,
    depth1: int,
    depth2: int,
    mode: str,
    return_distances: bool = False,
):
    """P4: K1's function in a design variant (`full`, `b4d`: K1 itself;
    `ohbf16`: K1 with the node selection on the tensor cores, wgmma).
    Returns [T*TILE, C] rows, and with `return_distances` (ohbf16 only)
    also the [T, C, TILE] distances the kernel selected and formed."""
    if mode not in VARIANT_IDS:
        raise ValueError(f"unknown variant {mode!r}; expected one of {tuple(VARIANT_IDS)}")
    if return_distances and mode != "ohbf16":
        raise ValueError("only the ohbf16 variant returns its distances")
    if _on_cpu(pos_blocks, uv, gtab, aux):
        rows = screen_ref.score_tiles_fused_variant(pos_blocks, uv, gtab, aux, depth1,
                                                    depth2, mode)
        if return_distances:
            return rows, screen_ref.packed_row_distances(pos_blocks, uv)
        return rows
    t, c = _tile_major(pos_blocks, uv, gtab, aux)
    _check_aligned(pos_blocks=pos_blocks, uv=uv)
    lib = load_library()
    out, dist = _rows_and_distances(t, c, pos_blocks.device, return_distances)
    if t:
        _launch("score_tiles_fused_variant", pos_blocks.device, lib.screen_tiles_fused_variant,
                pos_blocks, uv, gtab, aux, out, dist, t, c, int(depth1), int(depth2),
                VARIANT_IDS[mode], mode=mode)
    return (out, dist) if return_distances else out


def score_tiles_ohbf16_baseline(
    pos_blocks: torch.Tensor,  # K1's inputs
    uv: torch.Tensor,
    gtab: torch.Tensor,
    aux: torch.Tensor,
    depth1: int,
    depth2: int,
    return_distances: bool = False,
):
    """P4 ohbf16's first design (K1's first design with the selection on
    mma.sync): the baseline that the second design is held to bit for bit.
    Returns [T*TILE, C] rows and, with `return_distances`, the [T, C, TILE]
    distances. No route calls it."""
    if _on_cpu(pos_blocks, uv, gtab, aux):
        return score_tiles_fused_variant(pos_blocks, uv, gtab, aux, depth1, depth2, "ohbf16",
                                         return_distances)
    t, c = _tile_major(pos_blocks, uv, gtab, aux)
    lib = load_library()
    out, dist = _rows_and_distances(t, c, pos_blocks.device, return_distances)
    if t:
        _launch("score_tiles_ohbf16_baseline", pos_blocks.device,
                lib.screen_tiles_ohbf16_baseline, pos_blocks, uv, gtab, aux, out, dist, t, c,
                int(depth1), int(depth2))
    return (out, dist) if return_distances else out


def _rows_and_distances(t: int, c: int, device: torch.device, distances: bool):
    """P4's outputs: [T*TILE, C] rows and, when asked, [T, C, TILE]
    distances (else None, a null pointer to the kernel)."""
    out = torch.empty((t * TILE, c), dtype=torch.float32, device=device)
    dist = torch.empty((t, c, TILE), dtype=torch.float32, device=device) if distances else None
    return out, dist
