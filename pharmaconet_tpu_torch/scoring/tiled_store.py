"""Model-specific prepacked tile store: pack once, screen many times.

Every screening batch otherwise re-emits tile-major Gaussian tables that
depend only on (pharmacophore model, ligand), both known before the screen
starts. This module moves that emission to PREPACK time: the writers run
the host packers over the whole library once and store the final device
arrays (plus the host-tail metadata: pair-end rows, the precomputed
geometric prune, DFS candidate counts, and for v3 the baked assignment-tree
leaves) on disk. Screening then memory-maps each batch and goes straight to
the kernels (BatchScreener.score_stored).

Store layout (a directory; the format pharmaconet_tpu writes, so stores
move between the packages unchanged):
    meta.json                 shapes, depths, fingerprint, batch size
    names.npy                 ligand names (library order)
    batches/00000/  v2: gtab.npy [T, 3, P, tile], aux.npy [T, 7, tile],
                        uv.npy [T, tile] i32, pos_blocks.npy [T, 3*cmax, cap],
                        dt.npy [T, cmax, tile] (absent in v1 stores)
                    v3: dt.npy, gid.npy, tab.npy, aux.npy, ends.npy and the
                        leaf bake (leafb<k>_*.npy, leaf2_out*.np[yz])
                    host.npz  pair_end_rows, prune, dfs arrays, live map

All batches share ONE device shape (width/cmax pinned at write time, scan
depths maxed over the library).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils import profiling
from .batch_screen import PackedLigand, PackedModel

# v2 adds batches/*/dt.npy: prepack-time conformer distances read by K3
# (score_tiles_fused_dt) in place of K1's per-tile rebuild; v1 stores
# (no dt.npy) stay readable and run K1. v3 is a different LAYOUT
# (scoring/screen_v3.py: block-major rows + per-tile deduplicated group
# tables, about 4x smaller on disk than v2), written by write_v3_store
# (the prepack --tiles_out default) and read by K2.
STORE_VERSION = 2
_READABLE_VERSIONS = (1, 2, 3)


def model_fingerprint(model: PackedModel) -> str:
    """Stable content hash of the packed pharmacophore model (including
    screening weights, which are baked into the per-node weight vector)."""
    h = hashlib.sha256()
    for arr in (
        model.mu, model.std, model.weight, model.node_type,
        model.cluster_mask, model.cluster_center, model.cluster_size,
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(json.dumps(model.cluster_nodes).encode())
    return h.hexdigest()[:32]


@dataclass
class StoredBatch:
    """One screen-ready batch loaded from a tile store.

    Device-side fields are those of TiledBatch (K1's inputs) plus dt (K3's);
    the host tail uses the precomputed prune mask and DFS arrays instead of
    recomputing them per run."""

    gtab: np.ndarray
    aux: np.ndarray
    uv: np.ndarray
    pos_blocks: np.ndarray
    depth1: int
    depth2: int
    pair_end_rows: np.ndarray  # [NP] i64
    prune: np.ndarray  # [NP] bool (host_prune_mask, precomputed)
    # native-DFS fast path (consumed by _dfs_scores via `dfs_arrays`)
    dfs_pair_starts: np.ndarray  # [num] i64
    dfs_conformers: np.ndarray  # [num] i32
    dfs_active_offsets: np.ndarray  # [num+1] i32
    dfs_cand_counts: np.ndarray  # [sum active] i32
    live_index: np.ndarray  # [num] i32 — positions within the full batch
    batch_len: int  # full batch length incl. cluster-less ligands
    # v2: prepack-time conformer distances [T, C, tile], read by K3; None
    # for v1 stores (K1 rebuilds them from pos_blocks/uv)
    dt: np.ndarray | None = None
    index: int | None = None  # the batch's index in its store (TiledStore.load)

    @property
    def dfs_arrays(self):
        return (
            self.dfs_pair_starts, self.dfs_conformers,
            self.dfs_active_offsets, self.dfs_cand_counts,
        )

    @property
    def empty(self) -> bool:
        return self.gtab is None


@dataclass
class StoredV3Batch:
    """One screen-ready batch from a version-3 (block-major) tile store.

    Device fields feed K2 (ops/screen_cuda.score_tiles_v3_rows); the host
    tail (pair_end_rows/prune/dfs_arrays) is identical to StoredBatch and
    flows through BatchScreener.postprocess_stored unchanged."""

    dt: np.ndarray  # [T, cmax, tile] f32
    gid: np.ndarray  # [T, tile] i32
    tab: np.ndarray  # [T, g_cap, r_pad] f32
    aux: np.ndarray  # [T, 3, tile] f32
    depth: int  # library-max pair-scan depth (deeper-than-needed is a no-op)
    mn_cap: int
    g_cap: int
    # DFS-tail fields. Leaf-baked batches load these LAZILY (None +
    # host_path set): the leaf path never touches them, and skipping the
    # host.npz reads (~4 MB/batch) more than halves the per-batch load
    # cost. ensure_host_fields() materializes them for the rare fallbacks
    # (leaf-stripped stores).
    pair_end_rows: np.ndarray | None
    prune: np.ndarray | None
    dfs_pair_starts: np.ndarray | None
    dfs_conformers: np.ndarray | None
    dfs_active_offsets: np.ndarray | None
    dfs_cand_counts: np.ndarray | None
    live_index: np.ndarray
    batch_len: int
    # [NPpad] i32 — store-wide padded pair-end rows for the on-device
    # pair compaction (v3's group-sorted rows make host-side compaction a
    # scattered gather; see score_tiles_v3_pairs)
    ends_padded: np.ndarray | None = None
    # prepack-baked assignment-tree leaves in the dense window layout
    # (scoring/leaf_tree.py build_leaf_dense): with these set, leaf
    # evaluation runs as two batched products behind the pair kernel and
    # the screen-time host tail is reading [B] floats plus a DFS over the
    # few heavy-tail outlier ligands. None for bake_leaves=False stores.
    leaf2_ps: np.ndarray | None = None  # [B, L, W/8] u8 score bitplane
    leaf2_pc: np.ndarray | None = None  # [B, L, W/8] u8 cross bitplane
    leaf2_pw: np.ndarray | None = None  # [B, W] bool window prune mask
    leaf2_ends: np.ndarray | None = None  # [B*W] i32 window -> kernel rows
    leaf2_out_ends: np.ndarray | None = None  # [NOUT_pad] i32
    leaf2_out: dict | None = None  # outlier host-DFS arrays (leaf2_out.npz)
    leaf_conf: np.ndarray | None = None  # [store batch_size] i32 conformers
    # bucketed leaf layout (leaf_tree.build_leaf_buckets): K width-class
    # buckets, each a tuple
    # (ends2 [Bk*Wk] i32, plane_s [Bk,Lk,Wk/8] u8, plane_c, prune_w
    # [Bk,Wk] bool, conf [Bk] i32, lig_idx [Bk] i32). Mutually exclusive
    # with the single-window leaf2_* fields above.
    leaf_buckets: tuple | None = None
    leaf_nb: int = 0  # scatter target length (store batch_size)
    # host.npz path backing the lazy DFS-tail fields (leaf-baked loads)
    host_path: str | None = None
    index: int | None = None  # the batch's index in its store (TiledStore.load)

    def ensure_host_fields(self) -> None:
        """Materialize the lazily-skipped DFS-tail fields from host.npz."""
        if self.pair_end_rows is not None or self.host_path is None:
            return
        h = np.load(self.host_path)
        self.pair_end_rows = h["pair_end_rows"]
        self.prune = h["prune"]
        self.dfs_pair_starts = h["dfs_pair_starts"]
        self.dfs_conformers = h["dfs_conformers"]
        self.dfs_active_offsets = h["dfs_active_offsets"]
        self.dfs_cand_counts = h["dfs_cand_counts"]

    @property
    def dfs_arrays(self):
        self.ensure_host_fields()
        return (
            self.dfs_pair_starts, self.dfs_conformers,
            self.dfs_active_offsets, self.dfs_cand_counts,
        )

    @property
    def empty(self) -> bool:
        return self.dt is None


def _page_in(batch) -> None:
    """Force the disk read of a loaded batch's mmap-backed arrays.

    Touches one byte per 4 KiB page so the OS readahead pulls the file
    into the page cache on the calling (prefetch) thread instead of
    faulting on the main thread mid-dispatch."""
    arrays: list = []
    for f in dataclasses.fields(batch):
        a = getattr(batch, f.name)
        if isinstance(a, tuple):  # bucketed leaf arrays (tuple of tuples)
            for b in a:
                arrays.extend(b if isinstance(b, tuple) else (b,))
        else:
            arrays.append(a)
    for a in arrays:
        if isinstance(a, np.memmap) and a.size:
            flat = a.reshape(-1).view(np.uint8)
            # .npy data is header-offset (not page-aligned), so the strided
            # walk can miss the array's final page — touch the last byte too
            int(flat[::4096].sum(dtype=np.int64)) + int(flat[-1])


def _dfs_arrays_from_tb(tb) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Precompute the exact arrays the native DFS consumes (mirrors the
    conversion in batch_screen._dfs_scores)."""
    num = len(tb.ligand_clusters)
    pair_starts = np.array([s for s, _ in tb.pair_slices], dtype=np.int64)
    conformers = np.ascontiguousarray(tb.num_conformers.astype(np.int32)[:num])
    active_offsets = [0]
    cand_counts: list[int] = []
    for active, cands in tb.candidates:
        cand_counts.extend(len(cands[l]) for l in active)
        active_offsets.append(len(cand_counts))
    return (
        pair_starts,
        conformers,
        np.asarray(active_offsets, dtype=np.int32),
        np.asarray(cand_counts, dtype=np.int32)
        if cand_counts else np.zeros(0, np.int32),
    )


def write_tiled_store(
    out_dir: str | Path,
    model: PackedModel,
    packed: list[PackedLigand],
    names: list[str],
    batch_size: int = 2048,
    threads: int = 1,
    verbose: bool = True,
) -> dict:
    """Pack the whole library into screen-ready tile batches on disk.

    Every batch is pinned to one common device shape: cmax is the library
    maximum upfront; tile width grows monotonically while packing and the
    few early batches packed below the final width are repacked at the
    end, so the finished store has a single program shape."""
    from .batch_screen import host_prune_mask
    from .screen_tiles import TILE, tile_distances
    from .tiled_pack import build_tiled_batch

    out = Path(out_dir)
    (out / "batches").mkdir(parents=True, exist_ok=True)
    assert len(packed) == len(names)

    cmax = max((p.num_conformers for p in packed if p.clusters), default=1)
    n_batches = (len(packed) + batch_size - 1) // batch_size

    width: int | None = None  # current common width (rows)
    d1_max, d2_max = 1, 2
    batch_shapes: list[int] = []  # width each batch was written with
    rows_hint = 600.0
    # reuse output buffers across batches: numpy returns >128 KB blocks to
    # the OS on free, so fresh ~200 MB allocations re-page-fault every
    # batch (the same fix as the screener's _pack_buffers). np.save copies
    # to disk before the next pack reuses the buffers.
    buffers: dict = {}

    def pack_batch(bi: int, pin_width: int | None):
        nonlocal rows_hint
        chunk = packed[bi * batch_size : (bi + 1) * batch_size]
        live = [(i, p) for i, p in enumerate(chunk) if p.clusters]
        if not live:
            return None, np.zeros(0, np.int32), len(chunk)
        live_packed = [p for _, p in live]
        try:
            tb = build_tiled_batch(
                model, live_packed, threads=threads,
                rows_hint=int(rows_hint * len(live_packed)),
                width=pin_width, cmax=cmax, buffer_cache=buffers,
            )
        except ValueError:
            # pinned width too small for this batch: take its natural width
            tb = build_tiled_batch(
                model, live_packed, threads=threads,
                rows_hint=int(rows_hint * len(live_packed)),
                width=None, cmax=cmax, buffer_cache=buffers,
            )
        rows_hint = 0.7 * rows_hint + 0.3 * (tb.nst / max(1, len(live_packed)))
        return tb, np.asarray([i for i, _ in live], np.int32), len(chunk)

    def save_batch(bi: int, tb, live_idx: np.ndarray, batch_len: int) -> int:
        bdir = out / "batches" / f"{bi:05d}"
        bdir.mkdir(exist_ok=True)
        if tb is None:
            np.savez(bdir / "host.npz", empty=np.asarray(1),
                     live_index=live_idx, batch_len=np.asarray(batch_len))
            return 0
        np.save(bdir / "gtab.npy", tb.gtab)
        np.save(bdir / "aux.npy", tb.aux)
        np.save(bdir / "uv.npy", tb.uv)
        np.save(bdir / "pos_blocks.npy", tb.pos_blocks)
        np.save(bdir / "dt.npy", tile_distances(tb.pos_blocks, tb.uv))
        prune = host_prune_mask(tb, model)
        ps, cf, ao, cc = _dfs_arrays_from_tb(tb)
        np.savez(
            bdir / "host.npz",
            pair_end_rows=tb.pair_end_rows, prune=prune,
            dfs_pair_starts=ps, dfs_conformers=cf,
            dfs_active_offsets=ao, dfs_cand_counts=cc,
            live_index=live_idx, batch_len=np.asarray(batch_len),
            depths=np.asarray([tb.depth1, tb.depth2]),
        )
        return tb.gtab.shape[0] * TILE

    for bi in range(n_batches):
        tb, live_idx, blen = pack_batch(bi, width)
        if tb is not None:
            w = tb.gtab.shape[0] * TILE
            width = w if width is None else max(width, w)
            d1_max = max(d1_max, tb.depth1)
            d2_max = max(d2_max, tb.depth2)
        batch_shapes.append(save_batch(bi, tb, live_idx, blen))
        if verbose and (bi + 1) % 50 == 0:
            print(f"packed {bi + 1}/{n_batches} batches (width {width})")

    # second pass: repack the early batches written below the final width
    repacked = 0
    for bi, w in enumerate(batch_shapes):
        if w and w != width:
            tb, live_idx, blen = pack_batch(bi, width)
            save_batch(bi, tb, live_idx, blen)
            repacked += 1
    if verbose and repacked:
        print(f"repacked {repacked} batches to the final width {width}")

    np.save(out / "names.npy", np.asarray(names))
    meta = dict(
        version=STORE_VERSION,
        n_ligands=len(packed),
        n_batches=n_batches,
        batch_size=batch_size,
        width=width or 0,
        cmax=cmax,
        depth1=d1_max,
        depth2=d2_max,
        fingerprint=model_fingerprint(model),
    )
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta


def write_v3_store(
    out_dir: str | Path,
    model: PackedModel,
    packed: list[PackedLigand],
    names: list[str],
    batch_size: int = 2048,
    threads: int = 1,
    verbose: bool = True,
    bake_leaves: bool = True,
    leaf_caps: tuple[int, int] | None = None,
    leaf_layout: str = "buckets",
    leaf_wire: str = "sparse",
    device: str = "cuda",
) -> dict:
    """Pack the library into a version-3 (block-major) tile store.

    Same contract as write_tiled_store but the on-disk device layout is
    the v3 one (scoring/screen_v3.py), about 4x smaller per ligand. All
    batches share one device shape: (t, mn_cap, g_cap) natural per batch
    in pass 1, then outlier batches are re-emitted at the library maxima in
    pass 2 (t grows by neutral-tile padding without repacking; mn_cap/g_cap
    growth rebuilds the layout from a fresh pack).

    With `bake_leaves` (default), the assignment-tree search runs ONCE
    here per batch, on the pair table of the plain-torch reference engine
    run on `device`, and its visited leaves are baked into the window
    layout (scoring/leaf_tree.py): screen-time leaf evaluation is a row
    gather and two batched products, and the host tail is reading [B]
    floats plus a DFS over the few heavy-tail outlier ligands.
    `leaf_caps` overrides the automatic (leaves, window) cap selection.

    leaf_layout "buckets" (default) bakes width-class buckets
    (leaf_tree.build_leaf_buckets), so the window gather pays about
    E[ceil(nref/64)] slots per ligand instead of the p97 cap. "single"
    keeps the one-cap layout (build_leaf_dense).

    leaf_wire "sparse" (default; buckets layout only) ships the set-bit
    flat indices instead of packed bit-planes (several times fewer leaf
    bytes on disk and over the host-to-device link); the device rebuilds
    the planes with one scatter per bucket feeding the same products.
    "dense" keeps the bit-plane wire."""
    from .batch_screen import (
        BatchScreener,
        build_batch,
        compact_pair_table,
        host_prune_mask,
    )
    from .screen_tiles import TILE
    from .screen_v3 import V3_G_CAP, _neutral_aux, build_v3_layout

    out = Path(out_dir)
    (out / "batches").mkdir(parents=True, exist_ok=True)
    assert len(packed) == len(names)
    if leaf_wire not in ("dense", "sparse"):
        raise ValueError(f"unknown leaf_wire {leaf_wire!r}")
    if leaf_layout != "buckets":
        # the sparse wire exists only for the bucketed layout; "single"
        # (the comparison layout) always writes dense bit-planes
        leaf_wire = "dense"

    cmax = max((p.num_conformers for p in packed if p.clusters), default=1)
    n_batches = (len(packed) + batch_size - 1) // batch_size

    t_max, mn_max, g_max, depth_max = 0, 8, V3_G_CAP, 0
    shapes: list[tuple[int, int, int] | None] = []  # (t, mn_cap, g_cap)
    scorer = (
        BatchScreener(model, engine="reference", device=device)
        if bake_leaves else None
    )

    def build_vb_for(bi: int, mn_cap=None, g_cap=V3_G_CAP, nbt=None):
        chunk = packed[bi * batch_size : (bi + 1) * batch_size]
        live = [(i, p) for i, p in enumerate(chunk) if p.clusters]
        if not live:
            return None, None, np.zeros(0, np.int32), len(chunk)
        batch = build_batch(model, [p for _, p in live], cmax=cmax)
        vb = build_v3_layout(
            batch, mn_cap=mn_cap, g_cap=g_cap, nbt=nbt, model=model
        )
        return vb, batch, np.asarray([i for i, _ in live], np.int32), len(chunk)

    def save_vb(bi: int, vb, batch, live_idx: np.ndarray, batch_len: int):
        bdir = out / "batches" / f"{bi:05d}"
        bdir.mkdir(exist_ok=True)
        if vb is None:
            np.savez(bdir / "host.npz", empty=np.asarray(1),
                     live_index=live_idx, batch_len=np.asarray(batch_len))
            return
        np.save(bdir / "dt.npy", vb.dt)
        np.save(bdir / "gid.npy", vb.gid)
        np.save(bdir / "tab.npy", vb.tab)
        np.save(bdir / "aux.npy", vb.aux)
        prune = host_prune_mask(vb, model)
        ps, cf, ao, cc = _dfs_arrays_from_tb(vb)
        np.savez(
            bdir / "host.npz",
            pair_end_rows=vb.pair_end_rows, prune=prune,
            dfs_pair_starts=ps, dfs_conformers=cf,
            dfs_active_offsets=ao, dfs_cand_counts=cc,
            live_index=live_idx, batch_len=np.asarray(batch_len),
        )
        if scorer is not None:
            # enumerate the assignment-tree leaves against the final host
            # table (empty pairs 0.0, pruned -1.0 — what _dfs_scores
            # consumes) and save the RAW enumeration; pass 2b bakes it
            # into the dense window layout once the store-wide caps and
            # row count are known
            from .leaf_tree import enumerate_leaves, near_zero_gate_flags

            expanded = scorer._to_host(scorer.run_device(batch))
            table = compact_pair_table(batch, expanded)
            table[: len(prune)][prune] = -1.0
            assign, offsets = enumerate_leaves(vb, table)
            # ligands whose gate sign bits sit within epsilon of zero are
            # demoted to the screen-time host DFS (ADVICE r4: cross-backend
            # f32 rounding can flip a near-zero sign and change the baked
            # leaf set)
            sign_risky = near_zero_gate_flags(
                vb, table, vb.pair_end_rows, prune
            )
            np.savez(bdir / "leaves_raw.npz", assign=assign,
                     offsets=offsets, sign_risky=sign_risky)

    np_max = 0
    for bi in range(n_batches):
        vb, batch, live_idx, blen = build_vb_for(bi)
        if vb is not None:
            t = vb.dt.shape[0]
            t_max = max(t_max, t)
            mn_max = max(mn_max, vb.mn_cap)
            g_max = max(g_max, vb.g_cap)
            depth_max = max(depth_max, vb.depth)
            np_max = max(np_max, len(vb.pair_end_rows))
            shapes.append((t, vb.mn_cap, vb.g_cap))
        else:
            shapes.append(None)
        save_vb(bi, vb, batch, live_idx, blen)
        if verbose and (bi + 1) % 50 == 0:
            print(f"packed {bi + 1}/{n_batches} v3 batches (T {t_max})")

    # pass 2: bring every batch to the common (t_max, mn_max, g_max) shape
    repacked = padded = 0
    for bi, shape in enumerate(shapes):
        if shape is None or shape == (t_max, mn_max, g_max):
            continue
        t, mn_cap, g_cap = shape
        bdir = out / "batches" / f"{bi:05d}"
        if mn_cap != mn_max:
            # table row layout changes with mn_cap: rebuild from a pack
            vb, batch, live_idx, blen = build_vb_for(
                bi, mn_cap=mn_max, g_cap=g_max, nbt=t_max * TILE
            )
            save_vb(bi, vb, batch, live_idx, blen)
            repacked += 1
            continue
        # same mn_cap: grow by padding (slot ids are table-prefix indices,
        # so appending zero group slots / neutral tiles changes nothing)
        dt = np.load(bdir / "dt.npy")
        gid = np.load(bdir / "gid.npy")
        tab = np.load(bdir / "tab.npy")
        aux = np.load(bdir / "aux.npy")
        if g_cap != g_max:
            tab = np.concatenate(
                [tab, np.zeros((tab.shape[0], g_max - g_cap, tab.shape[2]),
                               np.float32)], axis=1)
        if t != t_max:
            extra = t_max - t
            dt = np.concatenate(
                [dt, np.zeros((extra,) + dt.shape[1:], np.float32)])
            gid = np.concatenate([gid, np.zeros((extra, TILE), np.int32)])
            tab = np.concatenate(
                [tab, np.zeros((extra,) + tab.shape[1:], np.float32)])
            aux = np.concatenate([aux, _neutral_aux(extra, TILE)])
        np.save(bdir / "dt.npy", dt)
        np.save(bdir / "gid.npy", gid)
        np.save(bdir / "tab.npy", tab)
        np.save(bdir / "aux.npy", aux)
        padded += 1
    if verbose and (repacked or padded):
        print(f"pass 2: {padded} batches padded, {repacked} rebuilt "
              f"to (T={t_max}, mn_cap={mn_max}, g_cap={g_max})")

    np_pad = max(8, ((np_max + 7) // 8) * 8)
    # pass 2c: store the device-compaction ends per batch as an mmap-able
    # .npy — loads skip the multi-MB host.npz pair_end_rows read entirely
    from .screen_v3 import padded_ends as _padded_ends

    for bi in range(n_batches):
        bdir = out / "batches" / f"{bi:05d}"
        host = np.load(bdir / "host.npz")
        if "empty" in host:
            continue
        np.save(bdir / "ends.npy", _padded_ends(host["pair_end_rows"], np_pad))

    leaf_meta: dict = {}
    if scorer is not None:
        # pass 2b: bake the raw leaf enumerations into the window layout
        # (leaf_tree.build_leaf_buckets / build_leaf_dense). Caps are store-wide statics
        # chosen at ~p97 of the per-ligand leaf / leaf-REFERENCED-row
        # distributions (hard ceilings 256 leaves / 512 window slots);
        # heavy-tail ligands above the caps join the host-DFS outlier set.
        from .leaf_tree import build_leaf_dense, leaf_window_stats

        stats: list[tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        for bi in range(n_batches):
            bdir = out / "batches" / f"{bi:05d}"
            if not (bdir / "leaves_raw.npz").exists():
                continue
            host = np.load(bdir / "host.npz")
            raw = np.load(bdir / "leaves_raw.npz")
            ps = host["dfs_pair_starts"]
            rows_per = np.diff(np.append(ps, len(host["pair_end_rows"])))
            nref_per, leaves_per = leaf_window_stats(
                raw["assign"], raw["offsets"],
                host["dfs_active_offsets"], host["dfs_cand_counts"],
            )
            risky = (
                raw["sign_risky"]
                if "sign_risky" in raw
                else np.zeros(len(nref_per), bool)
            )
            stats.append(
                (bi, rows_per.astype(np.int64), nref_per, leaves_per, risky)
            )
        if stats:
            all_ref = np.concatenate([r for _, _, r, _, _ in stats])
            all_leaves = np.concatenate([l for _, _, _, l, _ in stats])
            rnd = lambda n, m: int(((max(int(n), 1) + m - 1) // m) * m)  # noqa: E731
            if leaf_caps is not None:
                l_cap, w_cap = rnd(leaf_caps[0], 8), rnd(leaf_caps[1], 128)
            else:
                # demotion caps at ~p97 of the store's own distributions.
                # Hard ceilings exist only to bound pathological stores:
                # real fragment chemistry runs p97(leaves) ~ 600+ (the old
                # 256 ceiling demoted HALF the library to the host DFS),
                # and with width-class buckets only the heavy classes pay
                # for large caps, so the ceilings sit at 1024/768.
                l_cap = min(rnd(np.percentile(all_leaves, 97), 32), 1024)
                w_cap = min(rnd(np.percentile(all_ref, 97), 64), 768)
                # covering the true maxima costs nothing extra when close
                if all_leaves.max() <= 1024:
                    l_cap = max(l_cap, rnd(all_leaves.max(), 32))
                if all_ref.max() <= 768:
                    w_cap = max(w_cap, rnd(all_ref.max(), 64))
            nbt = t_max * TILE
            nout = 8
            for bi, rows_per, nref_per, leaves_per, risky in stats:
                outlier = (nref_per > w_cap) | (leaves_per > l_cap) | risky
                nout = max(nout, int(rows_per[outlier].sum()))
            nout = ((nout + 7) // 8) * 8

            bucket_specs: list[tuple[int, int, int]] = []
            if leaf_layout == "buckets":
                # width classes from the baked nref distribution; per-class
                # leaf cap = cummax of member maxima (monotone L keeps the
                # narrowest-W-fit assignment of build_leaf_buckets identical to the
                # capacity counts below); capacity = per-batch max count
                from .leaf_tree import choose_bucket_edges

                def _baked(r, l, k):
                    return (r <= w_cap) & (l <= l_cap) & ~k & (l > 0)

                all_baked_ref = np.concatenate([
                    r[_baked(r, l, k)] for _, _, r, l, k in stats
                ])
                edges = choose_bucket_edges(all_baked_ref)
                counts = np.zeros(len(edges), np.int64)
                lmaxs = np.zeros(len(edges), np.int64)
                for _, _, r, l, k in stats:
                    m = _baked(r, l, k)
                    ki = np.searchsorted(edges, r[m])
                    counts = np.maximum(
                        counts, np.bincount(ki, minlength=len(edges))
                    )
                    if m.any():
                        lm = np.zeros(len(edges), np.int64)
                        np.maximum.at(lm, ki, l[m])
                        lmaxs = np.maximum(lmaxs, lm)
                lmaxs = np.maximum.accumulate(lmaxs)
                rnd8 = lambda v: int(((max(int(v), 1) + 7) // 8) * 8)  # noqa: E731
                bucket_specs = [
                    (rnd8(counts[j]), rnd8(lmaxs[j]), int(edges[j]))
                    for j in range(len(edges))
                    if counts[j] > 0
                ]

            nnz_max = [[0, 0] for _ in bucket_specs]
            for bi, _rows_per, _nref_per, _leaves_per, risky in stats:
                bdir = out / "batches" / f"{bi:05d}"
                host = np.load(bdir / "host.npz")
                raw = np.load(bdir / "leaves_raw.npz")
                if leaf_layout == "buckets":
                    from .leaf_tree import build_leaf_buckets

                    demote = (
                        risky
                        | (_nref_per > w_cap)
                        | (_leaves_per > l_cap)
                    )
                    bake = build_leaf_buckets(
                        raw["assign"], raw["offsets"],
                        host["dfs_pair_starts"], host["dfs_conformers"],
                        host["dfs_active_offsets"], host["dfs_cand_counts"],
                        host["pair_end_rows"], host["prune"],
                        bucket_specs=bucket_specs, nbt=nbt,
                        batch_size=batch_size, nout_pad=nout,
                        force_demote=demote,
                    )
                    for k, b in enumerate(bake.buckets):
                        if leaf_wire == "sparse":
                            from .leaf_tree import planes_to_sparse

                            wk = bucket_specs[k][2]
                            sidx = planes_to_sparse(b.plane_score, wk)
                            cidx = planes_to_sparse(b.plane_cross, wk)
                            np.save(bdir / f"leafb{k}_sidx.npy", sidx)
                            np.save(bdir / f"leafb{k}_cidx.npy", cidx)
                            nnz_max[k][0] = max(nnz_max[k][0], len(sidx))
                            nnz_max[k][1] = max(nnz_max[k][1], len(cidx))
                        else:
                            np.save(bdir / f"leafb{k}_ps.npy", b.plane_score)
                            np.save(bdir / f"leafb{k}_pc.npy", b.plane_cross)
                        np.save(bdir / f"leafb{k}_pw.npy", b.prune_w)
                        np.save(bdir / f"leafb{k}_ends.npy", b.ends2)
                        np.save(bdir / f"leafb{k}_conf.npy", b.conf)
                        np.save(bdir / f"leafb{k}_idx.npy", b.lig_idx)
                    lb = bake  # shared outlier arrays below
                else:
                    lb = build_leaf_dense(
                        raw["assign"], raw["offsets"],
                        host["dfs_pair_starts"], host["dfs_conformers"],
                        host["dfs_active_offsets"], host["dfs_cand_counts"],
                        host["pair_end_rows"], host["prune"],
                        l_cap=l_cap, w_cap=w_cap, nbt=nbt,
                        batch_size=batch_size, nout_pad=nout,
                        force_demote=risky,
                    )
                    np.save(bdir / "leaf2_ps.npy", lb.plane_score)
                    np.save(bdir / "leaf2_pc.npy", lb.plane_cross)
                    np.save(bdir / "leaf2_pw.npy", lb.prune_w)
                    np.save(bdir / "leaf2_ends.npy", lb.ends2)
                np.save(bdir / "leaf2_out_ends.npy", lb.out_ends)
                np.savez(
                    bdir / "leaf2_out.npz",
                    live=lb.out_live, prune=lb.out_prune,
                    pair_starts=lb.out_pair_starts,
                    conformers=lb.out_conformers,
                    active_offsets=lb.out_active_offsets,
                    cand_counts=lb.out_cand_counts,
                    n_rows=np.asarray(lb.n_out_rows),
                )
                (bdir / "leaves_raw.npz").unlink()
            if leaf_wire == "sparse":
                # pass 2f: pad every batch's sparse index arrays to the
                # store-wide maxima (one program shape); pad value is the
                # plane size = out of bounds, dropped by the device scatter
                from .leaf_tree import _round_up

                from .leaf_tree import check_sparse_size

                pads = [
                    (max(_round_up(s, 128), 128), max(_round_up(c_, 128), 128))
                    for s, c_ in nnz_max
                ]
                for bi, *_rest in stats:
                    bdir = out / "batches" / f"{bi:05d}"
                    for k, (bk, lk, wk) in enumerate(bucket_specs):
                        size = bk * lk * wk
                        check_sparse_size(size)
                        for name, pad in (("sidx", pads[k][0]),
                                          ("cidx", pads[k][1])):
                            f = bdir / f"leafb{k}_{name}.npy"
                            a = np.load(f)
                            if len(a) < pad:
                                a = np.concatenate([
                                    a, np.full(pad - len(a), size, np.int32)
                                ])
                            np.save(f, a)
            if leaf_layout == "buckets":
                leaf_meta = dict(
                    leaf2_buckets=[list(s) for s in bucket_specs],
                    leaf2_nout=nout,
                    leaf_wire=leaf_wire,
                )
            else:
                leaf_meta = dict(
                    leaf2_l=l_cap, leaf2_w=w_cap, leaf2_nout=nout
                )
            if verbose:
                n_out_lig = sum(
                    int(((r > w_cap) | (l > l_cap) | k).sum())
                    for _, _, r, l, k in stats
                )
                n_risky = sum(int(k.sum()) for _, _, _, _, k in stats)
                desc = (
                    f"buckets {bucket_specs}"
                    if leaf_layout == "buckets"
                    else f"caps L={l_cap} W={w_cap}"
                )
                print(
                    f"leaf bake: {desc}, outliers "
                    f"{n_out_lig} ligands (host DFS, {n_risky} "
                    f"sign-epsilon demotions), NOUT_pad={nout}"
                )

    np.save(out / "names.npy", np.asarray(names))
    meta = dict(
        version=3,
        n_ligands=len(packed),
        n_batches=n_batches,
        batch_size=batch_size,
        t=t_max,
        cmax=cmax,
        mn_cap=mn_max,
        g_cap=g_max,
        depth=depth_max,
        np_pad=np_pad,
        fingerprint=model_fingerprint(model),
        **leaf_meta,
    )
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta


class TiledStore:
    """Reader for a prepacked tile store (mmap-backed)."""

    def __init__(self, path: str | Path, model: PackedModel | None = None):
        self.path = Path(path)
        self.meta = json.loads((self.path / "meta.json").read_text())
        if self.meta["version"] not in _READABLE_VERSIONS:
            raise ValueError(f"tile store version {self.meta['version']} unsupported")
        if model is not None:
            got = model_fingerprint(model)
            want = self.meta["fingerprint"]
            if got != want:
                raise ValueError(
                    "tile store was packed for a different pharmacophore "
                    f"model/weights (fingerprint {want} != {got}); re-run "
                    "prepack with the current model"
                )
        self.n_batches = self.meta["n_batches"]
        self.batch_size = self.meta["batch_size"]
        self.n_ligands = self.meta["n_ligands"]

    def names(self) -> list[str]:
        return [str(n) for n in np.load(self.path / "names.npy")]

    def load(self, bi: int, mmap: bool = True) -> StoredBatch | StoredV3Batch:
        """Load batch `bi` (`empty` where it has no scoreable ligand).
        The big device arrays are memory-mapped (mmap=True, read-only):
        hot page cache makes a repeat screen disk-free; the screener
        copies each mapped array out before it goes to the device. Span
        `pmnet.store.load`."""
        with profiling.span("pmnet.store.load", batch=bi):
            batch = self._load(bi, mmap)
        batch.index = bi
        return batch

    def _load(self, bi: int, mmap: bool):
        bdir = self.path / "batches" / f"{bi:05d}"
        host = np.load(bdir / "host.npz")
        if self.meta["version"] == 3:
            return self._load_v3(bdir, host, "r" if mmap else None)
        if "empty" in host:
            return StoredBatch(
                gtab=None, aux=None, uv=None, pos_blocks=None,
                depth1=self.meta["depth1"], depth2=self.meta["depth2"],
                pair_end_rows=np.zeros(0, np.int64),
                prune=np.zeros(0, bool),
                dfs_pair_starts=np.zeros(0, np.int64),
                dfs_conformers=np.zeros(0, np.int32),
                dfs_active_offsets=np.zeros(1, np.int32),
                dfs_cand_counts=np.zeros(0, np.int32),
                live_index=host["live_index"],
                batch_len=int(host["batch_len"]),
            )
        mm = "r" if mmap else None
        dt_path = bdir / "dt.npy"
        return StoredBatch(
            dt=np.load(dt_path, mmap_mode=mm) if dt_path.exists() else None,
            gtab=np.load(bdir / "gtab.npy", mmap_mode=mm),
            aux=np.load(bdir / "aux.npy", mmap_mode=mm),
            uv=np.load(bdir / "uv.npy", mmap_mode=mm),
            pos_blocks=np.load(bdir / "pos_blocks.npy", mmap_mode=mm),
            # library-max depths: running the bounded scans deeper than a
            # batch needs is a no-op, and one pair of depths serves the
            # whole store
            depth1=self.meta["depth1"],
            depth2=self.meta["depth2"],
            pair_end_rows=host["pair_end_rows"],
            prune=host["prune"],
            dfs_pair_starts=host["dfs_pair_starts"],
            dfs_conformers=host["dfs_conformers"],
            dfs_active_offsets=host["dfs_active_offsets"],
            dfs_cand_counts=host["dfs_cand_counts"],
            live_index=host["live_index"],
            batch_len=int(host["batch_len"]),
        )

    def iter_loaded(self, indices, prefetch: int = 2, mmap: bool = True):
        """Yield ``(bi, batch)`` for ``indices`` with a background loader.

        ``load`` is mmap-backed, so with a plain loop the disk page-ins
        happen lazily on the main thread, serialized with device dispatch.
        Here a worker thread loads (and explicitly pages in) up to
        ``prefetch`` batches ahead, overlapping disk I/O with the kernels
        and the host tail of the current batch. Order and content are
        identical to calling ``load`` per index (tests pin it). Spans
        `pmnet.store.page_in` (worker) and `pmnet.store.wait` (consumer)."""
        import queue
        import threading

        indices = list(indices)
        if not indices:
            return
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put: recheck the stop flag so an abandoned (never
            # GC'd) generator can't leave the producer blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for bi in indices:
                    if stop.is_set():
                        return
                    b = self.load(bi, mmap=mmap)
                    with profiling.span("pmnet.store.page_in", batch=bi):
                        _page_in(b)
                    if not put((bi, b)):
                        return
                put(None)
            except BaseException as e:  # surfaced on the consumer side
                put(e)

        t = threading.Thread(target=worker, daemon=True, name="tile-prefetch")
        t.start()
        try:
            for bi in [*indices, None]:  # None: the worker's end marker
                with profiling.span("pmnet.store.wait", batch=bi):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then reap it;
            # surface (don't swallow) a worker exception that raced the
            # consumer's break and was already enqueued — logged rather
            # than raised so it can't mask an in-flight consumer exception
            # propagating through this finally
            while t.is_alive():
                try:
                    item = q.get_nowait()
                    if isinstance(item, BaseException):
                        logging.getLogger(__name__).warning(
                            "tile-store prefetch worker failed during "
                            "generator close: %r", item,
                        )
                except queue.Empty:
                    pass
                t.join(timeout=0.1)

    def _load_v3(self, bdir: Path, host, mm) -> StoredV3Batch:
        m = self.meta
        if "empty" in host:
            return StoredV3Batch(
                dt=None, gid=None, tab=None, aux=None,
                depth=m["depth"], mn_cap=m["mn_cap"], g_cap=m["g_cap"],
                pair_end_rows=np.zeros(0, np.int64),
                prune=np.zeros(0, bool),
                dfs_pair_starts=np.zeros(0, np.int64),
                dfs_conformers=np.zeros(0, np.int32),
                dfs_active_offsets=np.zeros(1, np.int32),
                dfs_cand_counts=np.zeros(0, np.int32),
                live_index=host["live_index"],
                batch_len=int(host["batch_len"]),
            )
        from .screen_v3 import padded_ends

        has_buckets = (
            "leaf2_buckets" in m and (bdir / "leaf2_out.npz").exists()
        )
        has_leaves = "leaf2_l" in m and (bdir / "leaf2_ps.npy").exists()
        # stores written since the ends.npy pass mmap the padded ends
        # instead of re-deriving them from the 8-byte-per-pair signed copy
        # in host.npz on every load
        ends_path = bdir / "ends.npy"
        if ends_path.exists():
            ends = np.load(ends_path, mmap_mode=mm)
        elif "np_pad" in m:
            ends = padded_ends(host["pair_end_rows"], m["np_pad"])
        else:
            # pre-np_pad v3 store: host-side compaction fallback
            ends = None
        # the leaf path never touches the DFS-tail fields; defer their
        # host.npz reads to ensure_host_fields() (rare fallbacks only)
        lazy = (has_leaves or has_buckets) and ends is not None
        conformers = host["dfs_conformers"]
        if has_leaves or has_buckets:
            out_npz = np.load(bdir / "leaf2_out.npz")
            leaf2_out = {k: out_npz[k] for k in out_npz.files}
        leaf_buckets = None
        if has_buckets:
            if m.get("leaf_wire") == "sparse":
                # sparse wire: set-bit flat indices + a zero-byte [Lk, 0]
                # placeholder whose SHAPE carries the static leaf cap
                # (leaf_tree._bucket_scores_sparse); the int32 pad
                # sentinel bk*lk*wk must fit
                from .leaf_tree import check_sparse_size

                for bk, lk, wk in m["leaf2_buckets"]:
                    check_sparse_size(bk * lk * wk)
                leaf_buckets = tuple(
                    (
                        np.load(bdir / f"leafb{k}_ends.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_sidx.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_cidx.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_pw.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_conf.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_idx.npy", mmap_mode=mm),
                        np.zeros((m["leaf2_buckets"][k][1], 0), np.uint8),
                    )
                    for k in range(len(m["leaf2_buckets"]))
                )
            else:
                leaf_buckets = tuple(
                    (
                        np.load(bdir / f"leafb{k}_ends.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_ps.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_pc.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_pw.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_conf.npy", mmap_mode=mm),
                        np.load(bdir / f"leafb{k}_idx.npy", mmap_mode=mm),
                    )
                    for k in range(len(m["leaf2_buckets"]))
                )
        return StoredV3Batch(
            dt=np.load(bdir / "dt.npy", mmap_mode=mm),
            gid=np.load(bdir / "gid.npy", mmap_mode=mm),
            tab=np.load(bdir / "tab.npy", mmap_mode=mm),
            aux=np.load(bdir / "aux.npy", mmap_mode=mm),
            leaf2_ps=(
                np.load(bdir / "leaf2_ps.npy", mmap_mode=mm)
                if has_leaves else None
            ),
            leaf2_pc=(
                np.load(bdir / "leaf2_pc.npy", mmap_mode=mm)
                if has_leaves else None
            ),
            leaf2_pw=(
                np.load(bdir / "leaf2_pw.npy", mmap_mode=mm)
                if has_leaves else None
            ),
            leaf2_ends=(
                np.load(bdir / "leaf2_ends.npy", mmap_mode=mm)
                if has_leaves else None
            ),
            leaf2_out_ends=(
                np.load(bdir / "leaf2_out_ends.npy", mmap_mode=mm)
                if (has_leaves or has_buckets) else None
            ),
            leaf2_out=leaf2_out if (has_leaves or has_buckets) else None,
            leaf_buckets=leaf_buckets,
            leaf_nb=m["batch_size"] if has_buckets else 0,
            # conformer counts padded to the store batch size so every
            # batch shares one leaf-evaluation program shape
            leaf_conf=(
                np.pad(
                    conformers.astype(np.int32),
                    (0, m["batch_size"] - len(conformers)),
                )
                if has_leaves else None
            ),
            ends_padded=ends,
            # library-max shape params: every batch was brought to the
            # common (t, mn_cap, g_cap) at write time, and running the
            # pair scan deeper than a batch needs is a no-op
            depth=m["depth"], mn_cap=m["mn_cap"], g_cap=m["g_cap"],
            pair_end_rows=None if lazy else host["pair_end_rows"],
            prune=None if lazy else host["prune"],
            dfs_pair_starts=None if lazy else host["dfs_pair_starts"],
            dfs_conformers=conformers,
            dfs_active_offsets=None if lazy else host["dfs_active_offsets"],
            dfs_cand_counts=None if lazy else host["dfs_cand_counts"],
            live_index=host["live_index"],
            batch_len=int(host["batch_len"]),
            host_path=str(bdir / "host.npz") if lazy else None,
        )
