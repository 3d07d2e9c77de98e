"""Screening benchmark of the PyTorch/CUDA port on one card: bench.py's
counterpart, behind a correctness gate.

    python3 bench_torch.py [batch_size=2048] [iters=10] [--device cuda|cpu]

Prints one JSON line last: bench.py's `metric`, `value` and `unit` under
the same metric names, plus `mode`, `engine`, `batch_size`, `correct`, the
device (`{name, power_limit_w}` from nvidia-smi, or "cpu"), the timings and
the kernel launches of the run. The knobs are bench.py's environment
variables:

  BENCH_MODE         kernel (default) | host | e2e | stored | proxy
  BENCH_ENGINE       kernel mode's engine (below; default pallas-dt)
  BENCH_SHAPE        model clusters (20)
  BENCH_CONF         ligand conformers (4); above 8 the kernels launch once
                     per group of at most 8 conformer columns
  BENCH_STORE        stored mode's store: v2 (default) or v3
  BENCH_LEAVES       0 writes the v3 store without baked leaves
  BENCH_LEAF_LAYOUT  v3-leaf's leaf layout: buckets (default) or single
  BENCH_LEAF_WIRE    v3-leaf's bucket wire: sparse (default) or dense
  BENCH_THREADS      DFS threads of the stored mode's host tail (1)

Kernel mode times one engine's device work on tensors already on the card
(the headline batch: `make_synthetic_model(20)`, 2048 ligands x 4
conformers):

  pallas-dt     K3 (score_tiles_fused_dt_rows) on the distances a v2 store
                holds (tile_distances of the one-pass pack), over the tiles
                that hold rows
  v3            K2 (score_tiles_v3_rows) on BatchScreener.build_vb's layout
  v3-leaf       K2 and the torch leaf chain (leaf2_scores_multi over the
                buckets, 6- or 7-tuples as the store gives them, or
                leaf2_scores_device for the single layout) on batch 0 of a
                v3 store
  pallas        K4 (score_blocks_fused) on BatchScreener.device_args_tiled
  pallas-split  K5 (gaussian_phase) and the plain scans and fail tail
  xla           score_blocks_device, the plain-torch reference engine (no
                kernel)

Its rate is bench.py's: batch_size over the device time of one call, here
`stream_ms` (probes/timing.py: calls back to back on the card with no wait
for the host; `ms` is one call between two CUDA events, host work
included). `host` times the host pipeline (pack, pair compaction, prune,
DFS on a zero stand-in) per core; `e2e` times BatchScreener.score_packed
(the live route, K1) on the host clock up to the scores on the host;
`stored` times a store batch's load plus the host tail on a stand-in;
`proxy` times SBDDReward_Proxy._scoring_list on 2048 SMILES, featurization
included.

The gate (bench.py leaves correctness to the tests): before it times
anything, each run checks its work and on a miss exits 1 with no metric
line. Kernel mode holds every output of the engine against the same
function through the plain versions (ops/screen_ref.py) on the same
tensors (the xla engine: on a CPU copy), rtol 2e-5 / atol 1e-4 with equal
-1 masks, and the batch's final scores (after the host tail or the leaf
chain) against the reference engine's. `e2e` and `stored` hold their
scores against the reference engine on the same device; `host` checks one
score per ligand; `proxy` checks finite scores and the first 64 against
the same proxy on the CPU (rtol 1e-4 / atol 1e-5).

Not ported from bench.py: its probe of a hung device and its fall-back to
the CPU (and to the xla engine there), and its remarks on a remote TPU;
the port never carries on without the card. Its unroll-8 / unroll-32
timing slope and the input perturbation that defeats XLA's common
subexpression elimination give way to CUDA events, and `vs_baseline` (a
target set for a TPU chip) is dropped.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

MODES = ("kernel", "host", "e2e", "stored", "proxy")
ENGINES = ("pallas-dt", "v3", "v3-leaf", "pallas", "pallas-split", "xla")
RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance
PROXY_TOL = dict(rtol=1e-4, atol=1e-5)  # card against CPU (tests/test_torch_parallel_proxy.py)
PROXY_CHECKED = 64  # SMILES scored on the CPU as well
PROXY_SIDES, PROXY_CHANNELS, PROXY_HOTSPOTS = (4, 8, 16, 32, 64), 96, 16
METRICS = {  # bench.py's metric names and units
    "kernel": ("graph_match_screening_throughput", "ligands/sec/chip"),
    "host": ("screening_host_pipeline_throughput", "ligands/sec/core"),
    "e2e": ("screening_e2e_throughput", "ligands/sec"),
    "stored": ("screening_stored_host_throughput", "ligands/sec/core"),
    "proxy": ("proxy_inference_throughput", "molecules/sec/chip"),
}


class GateMiss(AssertionError):
    """A run's output disagrees with its reference: no metric is printed."""


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def device_info(device: torch.device):
    """{name, power_limit_w} of the card from nvidia-smi, or "cpu"."""
    if device.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit_w": float(limit.strip().split()[0])}


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of `got` against `want`; GateMiss outside rtol 2e-5 /
    atol 1e-4 or where their -1 (failed pair) masks differ."""
    if got.shape != want.shape:
        raise GateMiss(f"{name}: shape {tuple(got.shape)}, plain version {tuple(want.shape)}")
    want = want.to(got.device)
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if mism or not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise GateMiss(f"{name}: disagrees with its plain version "
                       f"(max abs err {err}, -1 mismatches {mism})")
    return err


def compare_scores(name: str, got, want) -> float:
    """Max abs error of final scores against the reference's; GateMiss
    outside rtol 2e-5 / atol 1e-4."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise GateMiss(f"{name}: {got.shape[0]} scores, reference {want.shape[0]}")
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    err = float(np.abs(got - want).max(initial=0.0))
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise GateMiss(f"{name}: {int(bad.sum())} scores off the reference engine's "
                       f"(ligand {i}: {got[i]} against {want[i]})")
    return err


# --------------------------------------------------------------------------
# kernel mode: the engines
# --------------------------------------------------------------------------
@dataclass
class Engine:
    """One engine's device work on tensors already on the device.

    `call()` returns the engine's outputs (a tuple of tensors), `plain()`
    the same outputs through the plain versions, `finish(outputs)` the
    batch's final scores (the host tail or the leaf chain's scores in
    batch order). `host` keeps the host arrays it was built from."""

    name: str
    call: Callable[[], tuple]
    plain: Callable[[], tuple]
    finish: Callable[[tuple], list]
    tiles: int
    host: dict = field(default_factory=dict)


def make_engine(engine: str, pm, ligands, device: torch.device, work: str,
                leaf_layout: str = "buckets", leaf_wire: str = "sparse") -> Engine:
    """The Engine for `engine` on the packed model `pm` and `ligands`;
    `work` is a directory for the v3-leaf store."""
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.scoring.batch_screen import (
        BatchScreener,
        _used_tiles,
        build_batch,
        scan_fail,
        score_blocks_device,
    )

    screener = BatchScreener(pm, device=device)
    dev = screener._to_device
    if engine == "pallas-dt":
        from pharmaconet_tpu_torch.scoring.screen_tiles import tile_distances
        from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch

        tb = build_tiled_batch(pm, ligands, threads=1)
        used = _used_tiles(tb)
        dt = tile_distances(tb.pos_blocks[:used], tb.uv[:used])
        args = (dev(dt), dev(tb.gtab[:used]), dev(tb.aux[:used]), tb.depth1, tb.depth2)
        log(f"pallas-dt: T={used} C={dt.shape[1]} depths=({tb.depth1}, {tb.depth2})")
        return Engine(
            engine, lambda: (screen_cuda.score_tiles_fused_dt_rows(*args),),
            lambda: (screen_ref.score_tiles_fused_dt_rows(*args),),
            lambda outs: screener.postprocess_tb(tb, outs[0]), used,
            dict(tb=tb, dt=dt))
    if engine == "v3":
        vb = screener.build_vb(build_batch(pm, ligands))
        args = (dev(vb.dt), dev(vb.gid), dev(vb.tab), dev(vb.aux), vb.depth, vb.mn_cap)
        ends = dev(vb.ends_padded).long()
        log(f"v3 layout: T={vb.dt.shape[0]} mn_cap={vb.mn_cap} g_cap={vb.g_cap} "
            f"tab={vb.tab.nbytes / 1e6:.1f}MB dt={vb.dt.nbytes / 1e6:.1f}MB")
        return Engine(
            engine, lambda: (screen_cuda.score_tiles_v3_rows(*args),),
            lambda: (screen_ref.score_tiles_v3_rows(*args),),
            lambda outs: screener.postprocess_vb(vb, outs[0].index_select(0, ends)),
            vb.dt.shape[0], dict(vb=vb))
    if engine == "v3-leaf":
        return _v3_leaf_engine(pm, ligands, device, work, leaf_layout, leaf_wire, screener)
    if engine in ("pallas", "pallas-split"):
        batch = build_batch(pm, ligands)
        tiled = screener.device_args_tiled(batch)
        g = tuple(dev(a) for a in (tiled.pos_blocks, tiled.uv_packed, tiled.muT,
                                   tiled.invT, tiled.winvT))
        names = ("flags_block", "flags_pair", "end_mn_inv", "end_mn_half", "end_fail_gate",
                 "thr_ns", "self_ns")
        d = (tiled.depth1, tiled.depth2)
        t = g[0].shape[0]
        log(f"{engine}: T={t} NS={g[2].shape[1]} depths={d}")

        def finish(outs):
            return screener.postprocess_expanded(batch, outs[-1], tiled.pair_end_rows)

        if engine == "pallas":
            rows = tuple(dev(getattr(tiled, n), torch.float32) for n in names)
            return Engine(
                engine, lambda: (screen_cuda.score_blocks_fused(*g, *rows, *d),),
                lambda: (screen_ref.score_blocks_fused(*g, *rows, *d),),
                finish, t, dict(tiled=tiled))
        rows = tuple(dev(getattr(tiled, n)) for n in names)  # the scans' own dtypes

        def split(gauss):
            sp = gauss(*g)
            c = sp.shape[0] // 2
            return sp, scan_fail(sp[:c], sp[c:], *rows, *d)

        return Engine(engine, lambda: split(screen_cuda.gaussian_phase),
                      lambda: split(screen_ref.gaussian_phase), finish, t, dict(tiled=tiled))
    if engine == "xla":
        batch = build_batch(pm, ligands)
        args, (d1, d2) = screener.device_args(batch)
        on_dev = tuple(dev(a) for a in args)
        on_cpu = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
        log(f"xla: NS={on_dev[1].shape[1]} NU={on_dev[4].shape[0]} depths=({d1}, {d2})")
        return Engine(
            engine, lambda: (score_blocks_device(*on_dev, depth1=d1, depth2=d2),),
            lambda: (score_blocks_device(*on_cpu, depth1=d1, depth2=d2),),
            lambda outs: screener.postprocess_expanded(batch, outs[0]),
            on_dev[1].shape[1] // 1024, dict(args=args, depths=(d1, d2)))
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def bucket_shape(b: tuple) -> tuple[int, int, int]:
    """(Bk, Lk, Wk) of a stored leaf bucket, dense 6-tuple or sparse
    7-tuple (whose last member is a [Lk, 0] placeholder)."""
    bk, wk = np.asarray(b[3]).shape
    lk = np.asarray(b[6]).shape[0] if len(b) == 7 else np.asarray(b[1]).shape[1]
    return bk, lk, wk


def _v3_leaf_engine(pm, ligands, device, work, layout, wire, screener) -> Engine:
    """K2 and the torch leaf chain on batch 0 of a v3 store written to
    `work`: the stored route's whole device program."""
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.scoring.leaf_tree import leaf2_scores_device, leaf2_scores_multi
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore, write_v3_store

    n = len(ligands)
    write_v3_store(work, pm, ligands, [f"l{i}" for i in range(n)], batch_size=n,
                   verbose=False, leaf_layout=layout, leaf_wire=wire, device=str(device))
    sb = TiledStore(work, pm).load(0)
    dev = screener._to_device  # copies each read-only store mapping out first
    k2 = tuple(dev(a) for a in (sb.dt, sb.gid, sb.tab, sb.aux))
    kw = dict(depth=sb.depth, mn_cap=sb.mn_cap)
    out_ends = dev(sb.leaf2_out_ends)
    if layout == "buckets":
        if sb.leaf_buckets is None:
            raise GateMiss("v3-leaf: the store holds no leaf buckets")
        buckets = tuple(tuple(dev(a) for a in b) for b in sb.leaf_buckets)
        specs = [bucket_shape(b) for b in sb.leaf_buckets]
        log(f"v3-leaf(buckets, {wire} wire): T={sb.dt.shape[0]} buckets={specs} "
            f"slots={sum(bk * wk for bk, _, wk in specs)} "
            f"outliers={len(sb.leaf2_out['live'])} NOUT_pad={len(sb.leaf2_out_ends)}")

        def chain(rows):
            return leaf2_scores_multi(rows, out_ends, buckets, nb=sb.leaf_nb)
    else:
        if sb.leaf2_ps is None:
            raise GateMiss("v3-leaf: the store holds no single-window leaves")
        flat = tuple(dev(a) for a in (sb.leaf2_ends, sb.leaf2_ps, sb.leaf2_pc, sb.leaf2_pw,
                                      sb.leaf_conf))
        log(f"v3-leaf(single): T={sb.dt.shape[0]} L={sb.leaf2_ps.shape[1]} "
            f"W={sb.leaf2_pw.shape[1]} outliers={len(sb.leaf2_out['live'])} "
            f"NOUT_pad={len(sb.leaf2_out_ends)}")

        def chain(rows):
            return leaf2_scores_device(rows, *flat, out_ends)

    def run(k2_fn):
        rows = k2_fn(*k2, **kw)
        return (rows, *chain(rows))

    return Engine("v3-leaf", lambda: run(screen_cuda.score_tiles_v3_rows),
                  lambda: run(screen_ref.score_tiles_v3_rows),
                  lambda outs: screener.postprocess_stored(sb, outs[1:]), sb.dt.shape[0],
                  dict(sb=sb))


def reference_scores(pm, ligands, device: torch.device) -> list[float]:
    """The plain-torch reference engine's scores on the same device."""
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener

    return BatchScreener(pm, engine="reference", device=device).score_packed(ligands)


def bench_kernel(engine: str, pm, ligands, device, iters: int, work: str,
                 leaf_layout: str, leaf_wire: str) -> dict:
    from pharmaconet_tpu_torch.probes.timing import time_rounds

    t0 = time.perf_counter()
    eng = make_engine(engine, pm, ligands, device, work, leaf_layout, leaf_wire)
    prep_s = time.perf_counter() - t0
    outs, plain = eng.call(), eng.plain()
    if len(outs) != len(plain):
        raise GateMiss(f"{engine}: {len(outs)} outputs, plain version {len(plain)}")
    err = max(compare(f"{engine} output {k}", o, p)
              for k, (o, p) in enumerate(zip(outs, plain)))
    score_err = compare_scores(f"{engine} scores", eng.finish(outs),
                               reference_scores(pm, ligands, device))
    times = time_rounds(device, {engine: eng.call}, reps=max(1, iters))[engine]
    per_batch = times.per_batch
    rate = len(ligands) / (per_batch / 1e3)
    log(f"device phase ({engine}): ms {times.ms:.4f} stream_ms {times.stream_ms} "
        f"enqueue_ms {times.enqueue_ms} gapless {times.gapless} -> {rate:,.0f} ligands/sec")
    return dict(value=rate, **times.as_dict(), tiles=eng.tiles, prep_s=prep_s,
                max_abs_err=err, max_score_err=score_err)


# --------------------------------------------------------------------------
# host, e2e, stored and proxy modes
# --------------------------------------------------------------------------
def host_times(fn, iters: int) -> float:
    """Median host seconds of fn() over `iters` calls (bench.py's loop)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_host(pm, ligands, device, iters: int) -> dict:
    """The host pipeline per core: the one-pass pack, pair compaction over
    a zero stand-in for the device's [rows, C] output, the geometric prune
    and the C++ DFS (bench.py's host mode)."""
    from pharmaconet_tpu_torch.scoring.batch_screen import (
        BatchScreener,
        _dfs_scores,
        compact_pair_table_rows,
        host_prune_mask,
    )
    from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch

    screener = BatchScreener(pm, device=device)
    screener.score_packed(ligands)  # warm: builds and pages
    out = {}

    def once():
        tb = build_tiled_batch(screener.packed_model, ligands, threads=screener.pack_threads,
                               rows_hint=int(screener._rows_hint * len(ligands)),
                               buffer_cache=screener._pack_buffers)
        rows = np.zeros((tb.gtab.shape[0] * tb.uv.shape[1], tb.cmax), np.float32)
        table = compact_pair_table_rows(rows, tb.pair_end_rows)
        prune = host_prune_mask(tb, screener.packed_model)
        table[: len(prune)][prune] = -1.0
        out["scores"] = _dfs_scores(tb, table)

    once()
    if len(out["scores"]) != len(ligands):
        raise GateMiss(f"host: {len(out['scores'])} scores for {len(ligands)} ligands")
    per_batch = host_times(once, iters)
    log(f"host-pipeline: {per_batch * 1e3:.2f} ms/batch per host core "
        "(pack+compact+prune+dfs)")
    return dict(value=len(ligands) / per_batch, batch_ms=per_batch * 1e3)


def bench_e2e(pm, ligands, device, iters: int) -> dict:
    """BatchScreener.score_packed on the device (the live route: the
    one-pass pack, K1, the host tail), host clock up to the scores."""
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener

    screener = BatchScreener(pm, device=device)
    scores = screener.score_packed(ligands)  # warm
    err = compare_scores("e2e scores", scores, reference_scores(pm, ligands, device))

    def once():
        screener.score_packed(ligands)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    per_batch = host_times(once, iters)
    log(f"e2e: {per_batch * 1e3:.2f} ms/batch -> {len(ligands) / per_batch:,.0f} lig/s")
    return dict(value=len(ligands) / per_batch, batch_ms=per_batch * 1e3, max_score_err=err)


def bench_stored(pm, ligands, device, iters: int, store: str, leaves: bool, threads: int,
                 work: str) -> dict:
    """A store batch's host tail per core: TiledStore.load(0) (memory
    mapped, warm page cache) plus postprocess_stored on a zero stand-in for
    the device result (its materialization included): the leaf chain's
    ([B] scores, outlier rows) for a leaf-baked v3 store, the pair table
    for a v3 store without leaves, K3's rows for a v2 store."""
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.tiled_store import (
        TiledStore,
        write_tiled_store,
        write_v3_store,
    )

    n = len(ligands)
    screener = BatchScreener(pm, pack_threads=threads, device=device)
    names = [f"l{i}" for i in range(n)]
    v3 = store == "v3"
    if v3:
        write_v3_store(work, pm, ligands, names, batch_size=n, verbose=False,
                       bake_leaves=leaves, device=str(device))
    else:
        write_tiled_store(work, pm, ligands, names, batch_size=n, verbose=False)
    st = TiledStore(work, pm)
    sb = st.load(0)
    with_leaves = v3 and (sb.leaf2_ps is not None or sb.leaf_buckets is not None)
    if with_leaves:
        nb = sb.leaf_nb if sb.leaf_buckets is not None else len(sb.leaf_conf)
        shape = (len(sb.leaf2_out_ends), sb.dt.shape[1])
    elif v3:
        shape = ((len(sb.ends_padded), sb.dt.shape[1]) if sb.ends_padded is not None
                 else (sb.dt.shape[0] * sb.dt.shape[2], sb.dt.shape[1]))
    else:
        shape = (sb.gtab.shape[0] * sb.gtab.shape[3], sb.pos_blocks.shape[1] // 3)

    def stand_in():
        if with_leaves:
            return torch.zeros(nb), torch.zeros(shape)
        return torch.zeros(shape)

    err = compare_scores(f"stored {store} scores", screener.score_stored(sb),
                         reference_scores(pm, ligands, device))
    out = {}

    def once():
        out["scores"] = screener.postprocess_stored(st.load(0), stand_in())

    once()
    if len(out["scores"]) != n:
        raise GateMiss(f"stored: {len(out['scores'])} scores for {n} ligands")
    per_batch = host_times(once, iters)
    kind = "v3+leaves" if with_leaves else store
    log(f"stored-pipeline ({kind}): {per_batch * 1e3:.2f} ms/batch -> "
        f"{n / per_batch:,.0f} lig/s per host core")
    return dict(value=n / per_batch, batch_ms=per_batch * 1e3, store=kind,
                max_score_err=err)


def proxy_inputs(seed: int = 0):
    """bench.py's proxy inputs: seeded normal features at 4..64 voxels a
    side x 96 channels and 16 hotspots."""
    rng = np.random.default_rng(seed)
    features = [rng.normal(0, 1, (1, d, d, d, PROXY_CHANNELS)).astype(np.float32)
                for d in PROXY_SIDES]
    infos = [{"hotspot_feature": rng.normal(0, 1, 192).astype(np.float32),
              "hotspot_position": tuple(rng.uniform(-5, 5, 3).tolist())}
             for _ in range(PROXY_HOTSPOTS)]
    return features, infos


def bench_proxy(batch_size: int, device, iters: int) -> dict:
    """SBDDReward_Proxy at the published widths from _init_random: one
    target cache, then _scoring_list on SMILES_POOL cycled to batch_size,
    SMILES featurization included."""
    from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy
    from pharmaconet_tpu_torch.synthetic import SMILES_POOL

    features, infos = proxy_inputs()
    smiles = [SMILES_POOL[i % len(SMILES_POOL)] for i in range(batch_size)]
    proxy = SBDDReward_Proxy(device=device)
    proxy._init_random()
    cache = proxy._get_cache(features, infos)
    scores = proxy._scoring_list(cache, smiles)  # warm
    if scores.shape != (batch_size,) or not np.isfinite(scores).all():
        raise GateMiss(f"proxy: {scores.shape} scores, finite {bool(np.isfinite(scores).all())}")
    cpu = SBDDReward_Proxy(device="cpu")
    cpu._init_random()
    head = smiles[:PROXY_CHECKED]
    want = cpu._scoring_list(cpu._get_cache(features, infos), head)
    got = scores[: len(head)]
    if not np.allclose(got, want, **PROXY_TOL):
        raise GateMiss(f"proxy: card against CPU, max abs err {np.abs(got - want).max()}")
    err = float(np.abs(got - want).max(initial=0.0))

    def once():
        float(np.sum(proxy._scoring_list(cache, smiles)))

    per_batch = host_times(once, iters)
    log(f"proxy batch={batch_size} {per_batch * 1e3:.1f} ms/batch")
    return dict(value=batch_size / per_batch, batch_ms=per_batch * 1e3, max_score_err=err)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def run(mode: str = "kernel", engine: str = "pallas-dt", batch_size: int = 2048,
        iters: int = 10, device: str | torch.device = "cuda", clusters: int = 20,
        conformers: int = 4, store: str = "v2", leaves: bool = True,
        leaf_layout: str = "buckets", leaf_wire: str = "sparse", threads: int = 1) -> dict:
    """One benchmark run; returns the fields of its JSON line. Raises
    GateMiss when the run's output disagrees with its reference."""
    from pharmaconet_tpu_torch.device import resolve_device
    from pharmaconet_tpu_torch.ops.launch_log import counts as launch_counts
    from pharmaconet_tpu_torch.scoring.batch_screen import PackedModel
    from pharmaconet_tpu_torch.synthetic import make_synthetic_ligands, make_synthetic_model

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    for name, value, allowed in (("store", store, ("v2", "v3")),
                                 ("leaf_layout", leaf_layout, ("buckets", "single")),
                                 ("leaf_wire", leaf_wire, ("sparse", "dense"))):
        if value not in allowed:
            raise ValueError(f"unknown {name} {value!r}; expected one of {allowed}")
    device = resolve_device(device)
    before = launch_counts()
    pm = ligands = None
    if mode != "proxy":
        pm = PackedModel.from_model(make_synthetic_model(num_clusters=clusters))
        ligands = make_synthetic_ligands(batch_size, num_conformers=conformers)
    loops = max(3, iters // 2)  # bench.py's count for the host-clock modes
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as work:
        if mode == "kernel":
            out = bench_kernel(engine, pm, ligands, device, iters, work, leaf_layout, leaf_wire)
        elif mode == "host":
            out = bench_host(pm, ligands, device, loops)
        elif mode == "e2e":
            out = bench_e2e(pm, ligands, device, loops)
        elif mode == "stored":
            out = bench_stored(pm, ligands, device, loops, store, leaves, threads, work)
        else:
            out = bench_proxy(batch_size, device, loops)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = launch_counts()
    metric, unit = METRICS[mode]
    return dict(
        metric=metric, value=out.pop("value"), unit=unit, mode=mode,
        engine=engine if mode == "kernel" else ("tiled" if mode == "e2e" else None),
        batch_size=batch_size, correct=True, device=device_info(device),
        clusters=clusters if mode != "proxy" else None,
        conformers=conformers if mode != "proxy" else None, iters=iters, **out,
        launches={k: after[k] - before.get(k, 0) for k in after if after[k] > before.get(k, 0)},
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Screening benchmark of the PyTorch/CUDA port (bench.py's modes and "
                    "engines, set by BENCH_MODE, BENCH_ENGINE, BENCH_SHAPE, BENCH_CONF, "
                    "BENCH_STORE, BENCH_LEAVES, BENCH_LEAF_LAYOUT, BENCH_LEAF_WIRE and "
                    "BENCH_THREADS); prints one JSON line last.")
    p.add_argument("batch_size", nargs="?", type=int, default=2048)
    p.add_argument("iters", nargs="?", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def options_from_env(env=os.environ) -> dict:
    """run()'s keywords from bench.py's environment knobs."""
    return dict(
        mode=env.get("BENCH_MODE", "kernel"), engine=env.get("BENCH_ENGINE", "pallas-dt"),
        clusters=int(env.get("BENCH_SHAPE", "20")), conformers=int(env.get("BENCH_CONF", "4")),
        store=env.get("BENCH_STORE", "v2"), leaves=env.get("BENCH_LEAVES", "1") != "0",
        leaf_layout=env.get("BENCH_LEAF_LAYOUT", "buckets"),
        leaf_wire=env.get("BENCH_LEAF_WIRE", "sparse"),
        threads=int(env.get("BENCH_THREADS", "1")),
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        result = run(batch_size=args.batch_size, iters=args.iters, device=args.device,
                     **options_from_env())
    except GateMiss as e:
        print(f"bench_torch: gate missed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
