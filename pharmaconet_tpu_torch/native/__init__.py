"""Native host runtime: the screening packers, prep, prune and DFS (ctypes).

The C++ sources sit beside this file. Each library is compiled with g++ at
first use into `pharmaconet_tpu_torch/_build/` (named by a hash of its
source and flags, written under a temporary name and renamed, so parallel
processes never load a half-written file). A build or load failure raises:
the screener's card path needs these libraries, and a quiet fallback would
route a batch through another kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
BUILD_DIR = _DIR.parent / "_build"
_state: dict[str, ctypes.CDLL] = {}


def build_shared(name: str, sources: list[Path], cmd_prefix: list[str],
                 flags: list[str], timeout: int) -> Path:
    """Compile `sources` into BUILD_DIR/lib<name>-<hash>.so unless it is
    already there; returns its path. Raises on a failed build."""
    h = hashlib.sha256(" ".join(cmd_prefix + flags).encode())
    for s in sources:
        h.update(s.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [*cmd_prefix, *flags, *map(str, sources), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build of {name} failed ({' '.join(cmd)}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def _load(name: str, src: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (once per source hash) and load a native library."""
    if name not in _state:
        path = build_shared(
            name, [_DIR / src], ["g++"],
            ["-O3", "-std=c++17", "-shared", "-fPIC", *extra_flags], timeout=300,
        )
        _state[name] = ctypes.CDLL(str(path))
    return _state[name]


_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_boolp = np.ctypeslib.ndpointer(np.bool_, flags="C_CONTIGUOUS")


def _configure(fn, restype, argtypes):
    if not hasattr(fn, "_configured"):
        fn.restype = restype
        fn.argtypes = argtypes
        fn._configured = True
    return fn


def get_block_packer():
    """The build_blocks symbol (native/block_packer.cpp)."""
    return _configure(_load("block_packer", "block_packer.cpp").build_blocks, ctypes.c_int32, [
        ctypes.c_int32, ctypes.c_int32,  # M, Mn
        _i32p, _i32p, _f32p, _f32p, _f32p,  # ct_offsets, ct_nodes, mu, std, weight
        ctypes.c_int32, ctypes.c_int32,  # B, ln
        _i32p, _i32p, _i32p,  # lig_cluster_offsets, cluster_node_offsets, cluster_nodes
        _i32p, _i32p,  # node_mask_offsets, node_masks
        _i32p, _i32p,  # active_offsets, active
        _i32p, _i32p,  # cand_offsets, cands
        ctypes.c_int32,  # P
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # caps
        _f32p, _f32p, _f32p, _i32p, _i32p,  # sub arrays
        _i32p, _i32p, _i32p,  # block arrays
        _f32p, _i32p,  # pair arrays
        _i64p, _i64p,  # pair_slices, out_counts
    ])


def get_prep_args():
    """The prep_args symbol (native/prep_args.cpp)."""
    return _configure(_load("prep_args", "prep_args.cpp").prep_args, ctypes.c_int32, [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # ns_real, ns, nb, np
        ctypes.c_int32,  # P
        _f32p, _f32p, _f32p,  # sub_mu, sub_std, sub_w
        _i32p, _i32p, _i32p, _i32p,  # sub_block, block_pair, block_mn, block_cross
        _f32p, _i32p,  # pair_threshold, pair_self
        _f32p, _f32p, _f32p,  # muT, invT, winvT
        _boolp, _boolp,  # flags_block, flags_pair
        _f32p, _f32p, _f32p,  # end_mn_inv, end_mn_half, end_fail_gate
        _f32p, _boolp,  # thr_ns, self_ns
        _i64p,  # out_max
    ])


def get_prune_pairs():
    """The prune_pairs symbol (native/prep_args.cpp)."""
    return _configure(_load("prep_args", "prep_args.cpp").prune_pairs, None, [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # np, cmax, lmax
        _i32p,  # pair_meta
        _f32p, _f32p,  # lig_center, lig_size
        _f32p, _f32p,  # model_center, model_size
        _boolp,  # pruned
    ])


_DFS_ARGS = [
    ctypes.c_int32,  # num_ligands
    _f32p, ctypes.c_int64,  # table, cmax
    _i64p, _i32p,  # pair_starts, conformers
    _i32p, _i32p,  # active_offsets, cand_counts
    _f32p,  # out_scores
]


def get_match_dfs():
    """The match_dfs symbol (native/match_dfs.cpp)."""
    lib = _load("match_dfs", "match_dfs.cpp", ("-pthread",))
    return _configure(lib.match_dfs, None, _DFS_ARGS)


def get_match_dfs_mt():
    """The thread-sharded match_dfs_mt symbol: per-ligand searches are
    independent, so any thread count gives identical scores."""
    lib = _load("match_dfs", "match_dfs.cpp", ("-pthread",))
    return _configure(lib.match_dfs_mt, None, [*_DFS_ARGS, ctypes.c_int32])


def get_match_dfs_leaves():
    """The match_dfs_leaves symbol (native/match_dfs.cpp): gated-tree leaf
    enumeration for the prepack-time leaf bake."""
    lib = _load("match_dfs", "match_dfs.cpp", ("-pthread",))
    return _configure(lib.match_dfs_leaves, ctypes.c_int64, [
        ctypes.c_int32,  # num_ligands
        _f32p, ctypes.c_int64,  # table, cmax
        _i64p, _i32p,  # pair_starts, conformers
        _i32p, _i32p,  # active_offsets, cand_counts
        ctypes.c_int32, ctypes.c_int64,  # lmax, capacity
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),  # assign_out
        _i64p,  # leaf_offsets
    ])


def get_tile_dt():
    """The tile_dt symbol (native/dt_tiles.cpp): prepack-time conformer
    distances for v2 tile stores. Built with -ffp-contract=off, so it is
    bit-identical to the numpy path of screen_tiles.tile_distances."""
    lib = _load("dt_tiles", "dt_tiles.cpp", ("-ffp-contract=off",))
    return _configure(lib.tile_dt, None, [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # t, c, tile, cap
        _f32p, _i32p, _f32p,  # pos, uv, out
    ])


def get_pack_tiled():
    """The pack_tiled symbol (native/pack_tiled.cpp, fused tiled packer)."""
    lib = _load("pack_tiled", "pack_tiled.cpp", ("-pthread",))
    return _configure(lib.pack_tiled, ctypes.c_int32, [
        ctypes.c_int32, ctypes.c_int32,  # M, Mn
        _i32p, _i32p, _f32p, _f32p, _f32p,  # ct_offsets, ct_nodes, mu, std, weight
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # B, ln, cmax
        _i32p, _i32p, _i32p,  # lig_cluster_offsets, cluster_node_offsets, cluster_nodes
        _i32p, _i32p,  # node_mask_offsets, node_masks
        _i32p, _i32p,  # active_offsets, active
        _i32p, _i32p,  # cand_offsets, cands
        _f32p,  # node_pos [B*ln, cmax*3]
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # P, tile, cap, threads
        ctypes.c_int64, ctypes.c_int64,  # t_alloc, cap_np
        _f32p, _f32p, _i32p, _f32p,  # gtab, aux, uv, pos_blocks
        _f32p, _i32p, _i64p, _i64p,  # pair_threshold, pair_meta, pair_end_rows, pair_slices
        _i64p,  # out [4]
    ])
