"""Smoke run of the PyTorch/CUDA port on one GPU (exits non-zero on any fault).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — needs torch.cuda; prints the card's name and power limit
  2. build   — compiles the CUDA kernels (nvcc, sm_90a) and the native host
               libraries (g++) from the sources in this checkout, in parallel
  3. kernels — at the headline batch (20-cluster model seed 0, 2048 ligands
               x 4 conformers seed 1) holds K1, K3, K4 and K5 against their
               plain torch versions on the card and times both; K3 on the
               batch's v2 store arrays; K1 also bit for bit against its
               first design (P3 `full`), timed beside it in the same rounds
  4. paths   — the --library CLI route on 4 x 2048 ligands (K1), and the
               native_pack=False (K4) and fused=False (K5) screener paths;
               each with the launch counts reset just before and read just
               after; every score against the plain-torch reference engine
  5. -d      — the CLI on ~200 random .sdf/.mol2 files, every score against
               the exact host GraphMatcher
  6. stored  — the stored route on phase 4's library: prepack the default
               store (v3, leaf buckets, sparse wire) of its 4 batches and
               screen it with --library_tiles (K2 + leaf chain), the
               same with --tiles_version 2 on 2 batches (K3), and a v3
               store without leaves on 1 batch through score_stored (K2 +
               compaction on the device); each route's launch counts reset
               just before and read just after, every score against the
               reference engine; K2 held against its plain version and, bit
               for bit, its first design (screen_tiles_v3_baseline), both
               timed on the default store's first batch, which is the
               headline batch at the shape the store pins for every batch;
               then 256 ligands x 12 conformers (more than one launch takes,
               so the wrappers launch per group of conformer columns)
               through --library (K1), a v3 store (K2) and a v2 store (K3),
               every score against the reference engine, launch counts read
  7. modeling — pocket modeling at the published architecture's full width
               (SwinV2-3D embed 96, depths 2/6/2/2, 64^3 x 33 input) on a
               synthetic pocket with a synthesized checkpoint: K6 held
               against its plain version on the pocket's padded atoms and,
               bit for bit, its first design (voxelize_pallas_baseline),
               both timed in the same rounds; K6's two launches timed
               apart (python -m pharmaconet_tpu_torch.probes.probe_voxelize,
               a subprocess); the modeling CLI (K6 launch
               count reset just before, read just after: once per pocket); its float32-segmentation run held against
               PharmacoNet(voxelizer="reference"); how far the default TF32
               mask decoder moves the maps (printed, not gated); the
               host-clock stages of one pocket
  8. probes  — the probe kernels P1-P4 at the headline batch: each probe
               entry point (python -m pharmaconet_tpu_torch.probes.*) run
               once as a subprocess, which checks and times its kernels;
               their launch counts and times read from its last line; then,
               on inputs from the probe modules' own prep, every kernel and
               mode held against its plain version on the card (P1/P2 pass
               counts and P4 ohbf16's distances exactly equal), P3 full and
               every P4 mode against K1's output on the same tiles (P4's
               bit for bit); P4 ohbf16 (K1 with the selection on wgmma)
               also bit for bit against its first design
               (score_tiles_ohbf16_baseline, mma.sync in K1's first
               design), rows and distances, timed beside it, with both
               designs' registers and spill bytes at every C
  9. smiles  — SMILES input, the distance-geometry embedder's torch backend
               on the card (no Pallas kernel on its path; K1 screens its
               output): C1, 64 fragment SMILES embedded and scored through
               K1 against GraphMatcher; C4, solo embeds bit-identical to the
               batched one; embed_program on the card against the CPU on the
               same draws (a full chunk and the drug-like panel) and one
               refinement step's times; thin_qr against torch.linalg.qr;
               then 2048 fragment SMILES x 8 conformers through prepack
               --smiles --embed_backend torch and screening --smiles (K1,
               launch counts reset just before and read just after, every
               score against the reference engine on the prepacked
               library), with the embedder's stages, steps, retry rounds
               and rejected share, and the numpy backend's prepack of the
               same file (one worker per core); one {"smiles": ...} line
Then prints the {"kernels": [...]} line, the nvidia-smi name/power line, and
last {"ok": true, "device": {...}}. A kernel's `ms` is one call between two
CUDA events (host work included), `stream_ms` its time per call back to
back with no wait for the host (`stream_gapless`), and `enqueue_ms` the
host's time to enqueue one (probes/timing.py). K1's, K2's, K6's and P4
ohbf16's entries add their first designs' `baseline_ms` and `baseline_stream_ms` (same
timers, same rounds), `bit_equal_to_baseline`, and `occupancy` /
`baseline_occupancy`: registers and local bytes per thread, shared memory
per block and blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
K6's `occupancy` per kernel of its two launches). K1-K3 add their launch
counts on the 12-conformer routes.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
F32_OPS_PER_S = 67e12  # H100 SXM published f32 rate outside the tensor cores
REPO = Path(__file__).resolve().parent
WORK = REPO / ".smoke_work"
N_BATCH, N_BATCHES, N_FILES = 2048, 4, 200
SCREEN_CU = "pharmaconet_tpu_torch/csrc/screen_fused.cu"
SCREEN_PALLAS = "pharmaconet_tpu/ops/screen_pallas.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build() -> float:
    from pharmaconet_tpu_torch import native
    from pharmaconet_tpu_torch.ops import screen_cuda, voxelize_cuda

    t0 = time.perf_counter()
    jobs = [screen_cuda.load_library, voxelize_cuda.load_library, native.get_pack_tiled,
            native.get_block_packer, native.get_prep_args, native.get_match_dfs,
            native.get_tile_dt]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(j) for j in jobs]:
            f.result()
    return time.perf_counter() - t0


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """Max abs error and -1 mismatches; raises outside the tolerance."""
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    err = float((got - want).abs().max())
    if mism or not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, -1 mismatches {mism})")
    return err, mism


def f32_ops(c: int, rows: int, entries: int, distance: bool, depths: tuple,
            per_entry: int = 9) -> int:
    """f32 operations the kernels must do (exp and sqrt as one): the
    distance, 9 per conformer of each row where it is rebuilt; 9 per
    (valid Gaussian entry, conformer), 7 without the exp and its -1/2; and
    where there are scans, one add per scan step and stacked value plus 3
    per conformer in the tails. `entries` counts this run's Gaussian
    entries with weight > 0."""
    ops = per_entry * c * entries + (9 * c * rows if distance else 0)
    if depths:
        ops += rows * (2 * c * sum(depths) + 3 * c)
    return ops


def valid_entries(weights: torch.Tensor) -> int:
    return int((weights > 0).sum())


def kernel_times(name: str, fn):
    """The kernel's Times (probes/timing.py): one call between two events
    (`ms`), and back to back with the host's enqueue time per call."""
    from pharmaconet_tpu_torch.probes.timing import time_rounds

    return time_rounds(torch.device("cuda"), {name: fn})[name]


def baseline_entry(name: str, fn, out: torch.Tensor, baseline, resources) -> dict:
    """K1 or K2 against its first design: `out` bit-equal to `baseline()`
    (raises otherwise), both timed in the same rounds, and both designs'
    registers, shared memory and blocks per SM. `resources` is (the first
    design's resource name, kernel_resources keywords). Returns the fields
    for the kernels line, `times` the new kernel's Times."""
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.probes.timing import time_rounds

    base = baseline()
    if not torch.equal(out, base):
        raise AssertionError(f"{name}: {int((out != base).sum())} of {out.numel()} values "
                             "differ from its first design's")
    times = time_rounds(torch.device("cuda"), {name: fn, "baseline": baseline})
    base_name, kw = resources
    return dict(times=times[name], baseline_ms=times["baseline"].ms,
                baseline_stream_ms=times["baseline"].stream_ms,
                baseline_enqueue_ms=times["baseline"].enqueue_ms,
                baseline_stream_gapless=times["baseline"].gapless, bit_equal_to_baseline=True,
                occupancy=screen_cuda.kernel_resources(name, **kw),
                baseline_occupancy=screen_cuda.kernel_resources(base_name, **kw))


def timing_fields(times, plain) -> dict:
    from pharmaconet_tpu_torch.probes.timing import time_ms

    return dict(ms=times.ms, plain_ms=time_ms(plain, 5), stream_ms=times.stream_ms,
                enqueue_ms=times.enqueue_ms, stream_gapless=times.gapless)


def kernel_entry(name, replaces, fn, plain, inputs, out, ops, tiles, source=SCREEN_CU,
                 times=None, baseline=None):
    """Holds `out` (the kernel's output) against `plain()`, times both
    (the kernel here unless `times` brings it from a probe's run) and
    computes the bound: each of `inputs` read once and `out` written once
    over the HBM rate, or `ops` f32 operations over the f32 rate.
    `baseline` (fn, resources) holds K1 or K2 to its first design
    (baseline_entry) and times the two together."""
    err, mism = compare(name, out, plain())
    extra = {}
    if baseline is not None:
        extra = baseline_entry(name, fn, out, *baseline)
        times = extra.pop("times")
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + out.numel() * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    entry = dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=0,
        max_abs_err=err, **timing_fields(times or kernel_times(name, fn), plain),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, minus1_mismatches=mism, tiles=tiles, bytes=nbytes, ops=ops, **extra,
    )
    log(f"  {name}: T={tiles} max_abs_err={err:.3g} -1 mismatches={mism} "
        f"ms={entry['ms']:.4f} stream_ms={entry['stream_ms']:.4f} "
        f"(gapless {entry['stream_gapless']}) enqueue_ms={entry['enqueue_ms']:.4f} "
        f"plain_ms={entry['plain_ms']:.3f} bound_ms={entry['bound_ms']:.4f}")
    if extra:
        log(f"    first design: bit-equal, ms={entry['baseline_ms']:.4f} "
            f"stream_ms={entry['baseline_stream_ms']:.4f} "
            f"(gapless {entry['baseline_stream_gapless']}); occupancy {entry['occupancy']}, "
            f"first design {entry['baseline_occupancy']}")
    return entry


def phase_kernels(pm, ligands, dev) -> dict:
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, build_batch
    from pharmaconet_tpu_torch.scoring.screen_tiles import tile_distances
    from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch

    def cuda(a):
        return torch.from_numpy(a).to(dev)

    out = {}
    tb = build_tiled_batch(pm, ligands, threads=8)
    used = -(-tb.nst // 1024)  # the tiles dispatch_tb sends (bucket padding stays home)
    k1_in = [cuda(a[:used]) for a in (tb.pos_blocks, tb.uv, tb.gtab, tb.aux)]
    d = (tb.depth1, tb.depth2)
    tiles, c = k1_in[0].shape[0], k1_in[0].shape[1] // 3
    k1 = lambda: screen_cuda.score_tiles_fused_rows(*k1_in, *d)  # noqa: E731
    k1_first = lambda: screen_cuda.score_tiles_fused_ablation(*k1_in, *d, "full")  # noqa: E731
    out["score_tiles_fused_rows"] = kernel_entry(
        "score_tiles_fused_rows", f"{SCREEN_PALLAS}:463", k1,
        lambda: screen_ref.score_tiles_fused_rows(*k1_in, *d),
        k1_in, k1(), f32_ops(c, tiles * 1024, valid_entries(k1_in[2][:, 2]), True, d), tiles,
        baseline=(k1_first, ("score_tiles_fused_ablation[full]", dict(c=c))))

    # K3 on the batch's v2 store arrays (the tiles that hold rows, as the
    # stored route sends them) and their prepack-time distances
    k3_in = [cuda(tile_distances(tb.pos_blocks[:used], tb.uv[:used])),
             cuda(tb.gtab[:used]), cuda(tb.aux[:used])]
    tiles3 = k3_in[0].shape[0]
    k3 = lambda: screen_cuda.score_tiles_fused_dt_rows(*k3_in, *d)  # noqa: E731
    out["score_tiles_fused_dt"] = kernel_entry(
        "score_tiles_fused_dt", f"{SCREEN_PALLAS}:262", k3, lambda: screen_ref.score_tiles_fused_dt_rows(*k3_in, *d),
        k3_in, k3(), f32_ops(c, tiles3 * 1024, valid_entries(k3_in[1][:, 2]), False, d), tiles3)

    screener = BatchScreener(pm, device=dev)
    tiled = screener.device_args_tiled(build_batch(pm, ligands))
    g_in = [cuda(tiled.pos_blocks), cuda(tiled.uv_packed), cuda(tiled.muT),
            cuda(tiled.invT), cuda(tiled.winvT)]
    rows_in = [cuda(a).float() for a in (
        tiled.flags_block, tiled.flags_pair, tiled.end_mn_inv, tiled.end_mn_half,
        tiled.end_fail_gate, tiled.thr_ns, tiled.self_ns)]
    d = (tiled.depth1, tiled.depth2)
    tiles = g_in[0].shape[0]
    k4 = lambda: screen_cuda.score_blocks_fused(*g_in, *rows_in, *d)  # noqa: E731
    entries = valid_entries(g_in[4])
    out["score_blocks_fused"] = kernel_entry(
        "score_blocks_fused", f"{SCREEN_PALLAS}:516", k4,
        lambda: screen_ref.score_blocks_fused(*g_in, *rows_in, *d),
        g_in + rows_in, k4(), f32_ops(c, tiles * 1024, entries, True, d), tiles)
    k5 = lambda: screen_cuda.gaussian_phase(*g_in)  # noqa: E731
    out["gaussian_phase"] = kernel_entry(
        "gaussian_phase", f"{SCREEN_PALLAS}:114", k5, lambda: screen_ref.gaussian_phase(*g_in),
        g_in, k5(), f32_ops(c, tiles * 1024, entries, True, ()), tiles)
    torch.cuda.synchronize()
    return out


def k2_entry(sb, dev) -> dict:
    """K2 against its plain version on one stored v3 batch: the arrays and
    shape (the store's common T, mn_cap and g_cap) the stored route
    launches it with."""
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref

    k2_in = [torch.from_numpy(np.array(a)).to(dev) for a in (sb.dt, sb.gid, sb.tab, sb.aux)]
    kw = dict(depth=sb.depth, mn_cap=sb.mn_cap)
    w2 = k2_in[2][:, :, 2 * sb.mn_cap : 3 * sb.mn_cap]  # [T, G, mn_cap]
    per_row = (w2 > 0).sum(-1).gather(1, k2_in[1].long())  # valid entries of each row
    k2 = lambda: screen_cuda.score_tiles_v3_rows(*k2_in, **kw)  # noqa: E731
    k2_first = lambda: screen_cuda.score_tiles_v3_baseline_rows(*k2_in, **kw)  # noqa: E731
    c, g_cap, r_pad = k2_in[0].shape[1], k2_in[2].shape[1], k2_in[2].shape[2]
    entry = kernel_entry(
        "score_tiles_v3", f"{SCREEN_PALLAS}:374", k2, lambda: screen_ref.score_tiles_v3_rows(*k2_in, **kw),
        k2_in, k2(), f32_ops(c, k2_in[1].numel(), int(per_row.sum()), False, (sb.depth,)),
        k2_in[0].shape[0],
        baseline=(k2_first, ("score_tiles_v3_baseline", dict(c=c, g_cap=g_cap, r_pad=r_pad))))
    # entries K2 evaluates: each group's up to its last of weight > 0 (the
    # first design evaluates all mn_cap of every row)
    last = ((w2 > 0) * torch.arange(1, sb.mn_cap + 1, device=dev)).amax(-1)
    evaluated = int(last.gather(1, k2_in[1].long()).sum())
    log(f"    K2 layout: mn_cap {sb.mn_cap}, g_cap {sb.g_cap}, depth {sb.depth}, "
        f"{k2_in[1].numel()} rows, {int(per_row.sum())} valid entries; entries evaluated: "
        f"{evaluated} (K2), {k2_in[1].numel() * sb.mn_cap} (first design)")
    entry.update(entries_evaluated=evaluated, baseline_entries_evaluated=k2_in[1].numel() * sb.mn_cap)
    torch.cuda.synchronize()
    return entry


def check_scores(name, got: dict, want: dict) -> float:
    if got.keys() != want.keys():
        raise AssertionError(f"{name}: ligand sets differ")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if abs(g - w) > ATOL + RTOL * abs(w):
            raise AssertionError(f"{name}: {k} scored {g}, reference {w}")
        worst = max(worst, abs(g - w))
    return worst


def read_csv(path: Path) -> dict[str, float]:
    lines = path.read_text().splitlines()
    if lines[0] != "path,score":
        raise AssertionError(f"{path}: unexpected header {lines[0]!r}")
    out = {}
    for line in lines[1:]:
        name, score = line.rsplit(",", 1)
        out[name] = float(score)
    return out


def stage_ms(pm, batch, dev) -> dict[str, float]:
    """Host-clock ms of the K1 route's stages for one batch: the one-pass
    pack (one thread, as each executor worker packs), the host-to-device
    copy + kernel, and the host tail (rows back, pair compaction, prune,
    DFS)."""
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch

    screener = BatchScreener(pm, device=dev, pack_threads=1)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        tb = build_tiled_batch(pm, batch, threads=1)
        t1 = time.perf_counter()
        rows = screener.dispatch_tb(tb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        screener.postprocess_tb(tb, rows)
        t3 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    names = ("pack", "copy+kernel", "tail")
    return {n: statistics.median(r[i] for r in runs) for i, n in enumerate(names)}


def phase_paths(model, pm, dev, kernels: dict, card: str):
    from pharmaconet_tpu_torch.cli.screening import build_parser, main
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.library import save_library
    from pharmaconet_tpu_torch.synthetic import make_synthetic_ligands

    n = N_BATCH * N_BATCHES
    packed = make_synthetic_ligands(n, num_conformers=4, seed=1)
    names = [f"lig{i:05d}" for i in range(n)]
    model.save(str(WORK / "model.pm"))
    save_library(WORK / "lib.npz", packed, names)

    # reference engine: plain torch score_blocks_device + the same DFS
    ref_screener = BatchScreener(pm, engine="reference", device=dev)
    ref = {}
    for s in range(0, n, N_BATCH):
        for k, v in zip(names[s : s + N_BATCH], ref_screener.score_packed(packed[s : s + N_BATCH])):
            ref[k] = v

    args = build_parser().parse_args([
        "-p", str(WORK / "model.pm"), "--library", str(WORK / "lib.npz"),
        "-o", str(WORK / "lib.csv"), "--batch_size", str(N_BATCH), "--device", str(dev),
    ])
    screen_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels["score_tiles_fused_rows"]["launches"] = screen_cuda.LAUNCHES["score_tiles_fused_rows"]
    counts = dict(screen_cuda.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"--library route exited {rc}")
    worst = check_scores("--library", read_csv(WORK / "lib.csv"), ref)
    log(f"  --library: {n} ligands, {wall:.3f} s wall (load + screen + CSV), "
        f"{n / wall:.1f} ligands/s on {card}, launches {counts}, "
        f"max |score - reference| {worst:.3g}")
    if counts["score_tiles_fused_rows"] < 1:
        raise AssertionError("--library route never launched K1")

    head = packed[:N_BATCH]
    log(f"  stages of one {N_BATCH}-ligand batch (host clock, median of 3): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stage_ms(pm, head, dev).items()))
    for name, kw in (("score_blocks_fused", dict(native_pack=False)),
                     ("gaussian_phase", dict(fused=False))):
        screener = BatchScreener(pm, device=dev, **kw)
        screen_cuda.reset_launch_counts()
        scores = screener.score_packed(head)
        torch.cuda.synchronize()
        counts = dict(screen_cuda.LAUNCHES)
        kernels[name]["launches"] = counts[name]
        worst = check_scores(name, dict(zip(names, scores)),
                             {k: ref[k] for k in names[:N_BATCH]})
        log(f"  {kw}: {N_BATCH} ligands, launches {counts}, max |score - reference| {worst:.3g}")
        if counts[name] < 1:
            raise AssertionError(f"{kw} path never launched {name}")
    return packed, names, ref


def phase_dir(model, dev) -> None:
    from pharmaconet_tpu_torch.cli.screening import build_parser, main
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.scoring.graph_match import GraphMatcher
    from pharmaconet_tpu_torch.scoring.ligand import Ligand
    from pharmaconet_tpu_torch.synthetic import write_random_library

    paths = write_random_library(WORK / "ligands", N_FILES, seed=42)
    args = build_parser().parse_args([
        "-p", str(WORK / "model.pm"), "-d", str(WORK / "ligands"),
        "-o", str(WORK / "dir.csv"), "--batch_size", "128", "--device", str(dev),
    ])
    screen_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main(args)
    if rc != 0:
        raise AssertionError(f"-d route exited {rc}")
    wall = time.perf_counter() - t0
    counts = dict(screen_cuda.LAUNCHES)
    exact = {str(p): GraphMatcher(model, Ligand.load_from_file(p)).run() for p in paths}
    worst = check_scores("-d", read_csv(WORK / "dir.csv"), exact)
    log(f"  -d: {len(paths)} files, {wall:.3f} s wall, launches {counts}, "
        f"max |score - GraphMatcher| {worst:.3g}")
    if counts["score_tiles_fused_rows"] < 1:
        raise AssertionError("-d route never launched K1")


def stored_stage_ms(screener, store, bi: int) -> dict[str, float]:
    """Host-clock ms of one stored batch's stages (median of 3): load (the
    store's mmap reads, paged in), copy + kernels (host-to-device copies,
    the kernel and, for leaf-baked v3 batches, the torch leaf chain;
    synchronised), and the host tail (scores back, and the DFS where the
    batch has no baked leaves or has leaf outliers)."""
    from pharmaconet_tpu_torch.scoring.tiled_store import _page_in

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        sb = store.load(bi)
        _page_in(sb)
        t1 = time.perf_counter()
        result = screener.dispatch_stored(sb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        screener.postprocess_stored(sb, result)
        t3 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    names = ("load", "copy+kernels", "tail")
    return {n: statistics.median(r[i] for r in runs) for i, n in enumerate(names)}


def run_stored_cli(kernel: str, batches: int, version: int, pm, packed, names, ref, dev,
                   card: str, tag: str | None = None, batch_size: int = N_BATCH,
                   stages: bool = True) -> tuple[int, Path]:
    """Port prepack writes a store of the first `batches` batches of the
    library, screening --library_tiles scores it; the CSV must match the
    reference engine and `kernel` must have launched in the screen.
    Returns its launch count and the store's directory."""
    from pharmaconet_tpu_torch.cli import prepack
    from pharmaconet_tpu_torch.cli.screening import build_parser, main
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.library import save_library
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore

    n = batch_size * batches
    tag = tag or f"v{version}"
    save_library(WORK / f"lib_{tag}.npz", packed[:n], names[:n])
    tiles = WORK / f"tiles_{tag}"
    t0 = time.perf_counter()
    rc = prepack.main(prepack.build_parser().parse_args([
        "--library", str(WORK / f"lib_{tag}.npz"), "-p", str(WORK / "model.pm"),
        "--tiles_out", str(tiles), "--tiles_version", str(version),
        "--batch_size", str(batch_size), "--pack_threads", "8", "--device", str(dev),
    ]))
    if rc != 0:
        raise AssertionError(f"prepack --tiles_version {version} exited {rc}")
    log(f"  prepack v{version}: {n} ligands in {time.perf_counter() - t0:.3f} s (host + card)")

    args = build_parser().parse_args([
        "-p", str(WORK / "model.pm"), "--library_tiles", str(tiles),
        "-o", str(WORK / f"{tag}.csv"), "--device", str(dev),
    ])
    screen_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(screen_cuda.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"--library_tiles ({tag}) exited {rc}")
    worst = check_scores(f"--library_tiles {tag}", read_csv(WORK / f"{tag}.csv"),
                         {k: ref[k] for k in names[:n]})
    log(f"  --library_tiles {tag}: {n} ligands, {wall:.3f} s wall (load + screen + CSV), "
        f"{n / wall:.1f} ligands/s on {card}, launches {counts}, "
        f"max |score - reference| {worst:.3g}")
    if counts[kernel] < 1:
        raise AssertionError(f"--library_tiles {tag} never launched {kernel}")
    if not stages:
        return counts[kernel], tiles
    store = TiledStore(tiles)
    stages = stored_stage_ms(BatchScreener(pm, device=dev, pack_threads=1), store, 0)
    log(f"  stages of one stored {tag} batch (host clock, median of 3): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()))
    return counts[kernel], tiles


def phase_stored(pm, packed, names, ref, dev, kernels: dict, card: str) -> None:
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore, write_v3_store

    launches, tiles = run_stored_cli("score_tiles_v3", N_BATCHES, 3, pm, packed, names, ref,
                                     dev, card)
    kernels["score_tiles_v3"] = k2_entry(TiledStore(tiles).load(0), dev)
    kernels["score_tiles_v3"]["launches"] = launches
    launches, _ = run_stored_cli("score_tiles_fused_dt", 2, 2, pm, packed, names, ref, dev, card)
    kernels["score_tiles_fused_dt"]["launches"] = launches

    # K2 + pair compaction on the device: a v3 store without baked leaves
    write_v3_store(WORK / "tiles_noleaf", pm, packed[:N_BATCH], names[:N_BATCH],
                   batch_size=N_BATCH, threads=8, verbose=False, bake_leaves=False)
    store = TiledStore(WORK / "tiles_noleaf", pm)
    screener = BatchScreener(pm, device=dev)
    screen_cuda.reset_launch_counts()
    scores = [s for bi in range(store.n_batches) for s in screener.score_stored(store.load(bi))]
    torch.cuda.synchronize()
    counts = dict(screen_cuda.LAUNCHES)
    worst = check_scores("v3 without leaves", dict(zip(store.names(), scores)),
                         {k: ref[k] for k in names[:N_BATCH]})
    log(f"  v3 store without leaves (score_stored, pairs compacted on the card): "
        f"{N_BATCH} ligands, launches {counts}, max |score - reference| {worst:.3g}")
    if counts["score_tiles_v3"] < 1:
        raise AssertionError("the v3 route without leaves never launched score_tiles_v3")


MANY_CONFORMERS, MANY_LIGANDS, MANY_BATCH = 12, 256, 128


def phase_many_conformers(model, pm, dev, kernels: dict, card: str) -> None:
    """A library of 256 ligands with 12 conformers each (more than one
    launch takes: the wrappers score groups of conformer columns) screened
    through --library (K1), a v3 store (K2 + leaf chain) and a v2 store
    (K3), every score against the reference engine, each route's launch
    counts reset just before and read just after."""
    from pharmaconet_tpu_torch.cli.screening import build_parser, main
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.library import save_library
    from pharmaconet_tpu_torch.synthetic import make_synthetic_ligands

    packed = make_synthetic_ligands(MANY_LIGANDS, num_conformers=MANY_CONFORMERS, seed=5)
    names = [f"many{i:03d}" for i in range(MANY_LIGANDS)]
    ref_screener = BatchScreener(pm, engine="reference", device=dev)
    ref = dict(zip(names, ref_screener.score_packed(packed)))
    batches = MANY_LIGANDS // MANY_BATCH
    least = batches * len(screen_cuda.conformer_groups(MANY_CONFORMERS))  # a launch per group
    save_library(WORK / "lib_many.npz", packed, names)
    args = build_parser().parse_args([
        "-p", str(WORK / "model.pm"), "--library", str(WORK / "lib_many.npz"),
        "-o", str(WORK / "many.csv"), "--batch_size", str(MANY_BATCH), "--device", str(dev),
    ])
    screen_cuda.reset_launch_counts()
    rc = main(args)
    torch.cuda.synchronize()
    counts = dict(screen_cuda.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"--library ({MANY_CONFORMERS} conformers) exited {rc}")
    worst = check_scores(f"--library {MANY_CONFORMERS} conformers", read_csv(WORK / "many.csv"), ref)
    log(f"  --library, {MANY_LIGANDS} ligands x {MANY_CONFORMERS} conformers: launches "
        f"{ {k: v for k, v in counts.items() if v} }, max |score - reference| {worst:.3g}")
    launches = {"score_tiles_fused_rows": counts["score_tiles_fused_rows"]}
    for kernel, version in (("score_tiles_v3", 3), ("score_tiles_fused_dt", 2)):
        launches[kernel], _ = run_stored_cli(kernel, batches, version, pm, packed, names, ref,
                                             dev, card, tag=f"many_v{version}",
                                             batch_size=MANY_BATCH, stages=False)
    for kernel, n in launches.items():
        if n < least:
            raise AssertionError(f"{kernel}: {n} launches for {MANY_CONFORMERS} conformers in "
                                 f"{batches} batches; the conformer groups need {least}")
        kernels[kernel][f"launches_{MANY_CONFORMERS}_conformers"] = n


# --------------------------------------------------------------------------
# Phase 7: pocket modeling
# --------------------------------------------------------------------------
POCKET_SEED = 0
CKPT_SEED, CKPT_SCALE = 23, 0.8  # synthesized checkpoint (see PERF.md, phase 7)
K6_OPS_PER_PAIR = 76  # d2 (8), exp and its argument (2), 33 channel multiply-adds (66)
VOXEL_TOL = 1e-5  # image atol/rtol against the plain version (sums in another order)


def k6_pairs(args, dim: int = 64) -> int:
    """(voxel, valid atom) pairs within the feature radius: the pairs
    whose contributions K6 must compute for this pocket."""
    from pharmaconet_tpu_torch import constants as C
    from pharmaconet_tpu_torch.ops.voxelize import grid_coordinates

    pos, _, valid, center = args
    pos = pos[valid]
    voxels = grid_coordinates(center, C.GRID_RESOLUTION, dim)
    total = 0
    for s in range(0, voxels.shape[0], 8192):
        d2 = ((voxels[s : s + 8192, None, :] - pos[None]) ** 2).sum(-1)
        total += int((d2 <= C.FEATURE_RADII**2).sum())
    return total


def k6_entry(data, dev) -> dict:
    """K6 against its plain version on the pocket's padded atoms (the
    4096 bucket, 64^3 grid): occupancy bit-equal, image within VOXEL_TOL;
    and bit for bit against its first design (voxelize_pallas_baseline),
    both timed in the same rounds, with both designs' resources."""
    from pharmaconet_tpu_torch.ops import voxelize as plain, voxelize_cuda
    from pharmaconet_tpu_torch.probes.timing import time_rounds

    args = [torch.from_numpy(a).to(dev) for a in (
        data.atom_positions, data.atom_features, data.atom_valid, data.center)]
    img, occ = voxelize_cuda.voxelize_pallas(*args)
    base_img, base_occ = voxelize_cuda.voxelize_pallas_baseline(*args)
    want_img, want_occ = plain.voxelize(*args)
    torch.cuda.synchronize()
    occ_mism = int((occ != want_occ).sum())
    err = float((img - want_img).abs().max())
    if occ_mism or not torch.allclose(img, want_img, atol=VOXEL_TOL, rtol=VOXEL_TOL):
        raise AssertionError(f"voxelize_pallas: kernel disagrees with its plain version "
                             f"(max abs err {err}, occupancy mismatches {occ_mism})")
    if not (torch.equal(img, base_img) and torch.equal(occ, base_occ)):
        raise AssertionError(f"voxelize_pallas: {int((img != base_img).sum())} image values and "
                             f"{int((occ != base_occ).sum())} occupancy values differ from its "
                             "first design's")
    pairs = k6_pairs(args)
    nbytes = sum(t.numel() * t.element_size() for t in args) + img.numel() * 4 + occ.numel()
    ops = pairs * K6_OPS_PER_PAIR
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    times = time_rounds(dev, {"voxelize_pallas": lambda: voxelize_cuda.voxelize_pallas(*args),
                              "baseline": lambda: voxelize_cuda.voxelize_pallas_baseline(*args)})
    base = times["baseline"]
    entry = dict(
        name="voxelize_pallas", route="cuda", source="pharmaconet_tpu_torch/csrc/voxelize.cu",
        replaces="pharmaconet_tpu/ops/voxelize_pallas.py:145", launches=0, max_abs_err=err,
        **timing_fields(times["voxelize_pallas"], lambda: plain.voxelize(*args)),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, occupancy_mismatches=occ_mism, atoms=int(data.atom_valid.sum()),
        atom_bucket=int(data.atom_positions.shape[0]), pairs=pairs, bytes=nbytes, ops=ops,
        baseline_ms=base.ms, baseline_stream_ms=base.stream_ms, baseline_enqueue_ms=base.enqueue_ms,
        baseline_stream_gapless=base.gapless, bit_equal_to_baseline=True,
        occupancy={part: voxelize_cuda.kernel_resources(f"voxelize_pallas[{part}]")
                   for part in ("bin", "tile")},
        baseline_occupancy=voxelize_cuda.kernel_resources("voxelize_pallas_baseline"),
    )
    log(f"  voxelize_pallas: {entry['atoms']} atoms (bucket {entry['atom_bucket']}), "
        f"{pairs} voxel-atom pairs within 1.5 A, occupancy mismatches 0, "
        f"max_abs_err={err:.3g} ms={entry['ms']:.4f} stream_ms={entry['stream_ms']:.4f} "
        f"(gapless {entry['stream_gapless']}) enqueue_ms={entry['enqueue_ms']:.4f} "
        f"plain_ms={entry['plain_ms']:.3f} "
        f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']})")
    log(f"    first design: bit-equal, ms={base.ms:.4f} stream_ms={base.stream_ms:.4f} "
        f"(gapless {base.gapless}); occupancy {entry['occupancy']}, first design "
        f"{entry['baseline_occupancy']}")
    return entry


def run_modeling_cli(pdb: Path, center, ckpt: Path, out_dir: Path, dev, *extra: str):
    """The modeling CLI on the card; returns (.pm path, wall s, K6 launches)."""
    from pharmaconet_tpu_torch.cli.modeling import build_parser, main
    from pharmaconet_tpu_torch.ops import voxelize_cuda

    x, y, z = center
    args = build_parser().parse_args([
        "-p", str(pdb), "--center", str(x), str(y), str(z), "--prefix", "pocket",
        "--out_dir", str(out_dir), "--weight_path", str(ckpt), "--device", str(dev), *extra])
    voxelize_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = voxelize_cuda.LAUNCHES["voxelize_pallas"]
    if rc != 0:
        raise AssertionError(f"modeling CLI {' '.join(extra)} exited {rc}")
    if launches != 1:
        raise AssertionError(f"the modeling CLI launched voxelize_pallas {launches} times, "
                             "not once per pocket")
    return out_dir / f"pocket_{x}_{y}_{z}_model.pm", wall, launches


def check_hotspots(name: str, got: list, want: list) -> float:
    """Same hotspot list (type, position, score within 1e-6); returns the
    largest map difference."""
    if [(h["nci_type"], h["hotspot_position"]) for h in got] != \
            [(h["nci_type"], h["hotspot_position"]) for h in want]:
        raise AssertionError(f"{name}: hotspot lists differ ({len(got)} vs {len(want)})")
    worst = 0.0
    for a, b in zip(got, want):
        if abs(a["hotspot_score"] - b["hotspot_score"]) > 1e-6:
            raise AssertionError(f"{name}: hotspot score {a['hotspot_score']} vs "
                                 f"{b['hotspot_score']}")
        worst = max(worst, float(np.abs(a["point_map"] - b["point_map"]).max()))
    return worst


def check_pm(name: str, got, want) -> float:
    """Same .pm node and cluster counts and node types; node scores within
    the repo tolerance. Returns the largest node centre difference."""
    if (len(got.nodes), len(got.node_clusters)) != (len(want.nodes), len(want.node_clusters)):
        raise AssertionError(f"{name}: {len(got.nodes)} nodes / {len(got.node_clusters)} "
                             f"clusters vs {len(want.nodes)} / {len(want.node_clusters)}")
    worst = 0.0
    for a, b in zip(got.nodes, want.nodes):
        if a.type != b.type or abs(a.score - b.score) > ATOL + RTOL * abs(b.score):
            raise AssertionError(f"{name}: node {a.index} {a.type} {a.score} vs "
                                 f"{b.type} {b.score}")
        worst = max(worst, float(np.abs(np.subtract(a.center, b.center)).max()))
    return worst


def modeling_stages(net, pdb: Path, center) -> dict[str, float]:
    """Host-clock ms of one pocket's stages (median of 3), each ending in
    a synchronize: parse, voxelize (K6), trunk (SwinV2-3D + FPN), heads
    (cavity/token heads + gating), segmentation (mask decoder, per chunk
    of 16), postprocess (mask/smooth/threshold + sparse compaction + the
    host copy and rebuild, per chunk) and the graph build."""
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    runs = []
    for _ in range(3):
        data, t_parse = timed(lambda: net.parse(pdb, center=center))
        (image, occ), t_vox = timed(lambda: net.voxelize(data))
        pyramid, t_trunk = timed(lambda: net.trunk(image))
        out, t_heads = timed(lambda: net.heads(data, pyramid, occ))
        keep = np.nonzero(out["keep"].cpu().numpy())[0]
        rel = out["rel_scores"].cpu().numpy()
        tokens = torch.from_numpy(data.tokens).to(net.device)
        chunk = net.segmentation_chunk
        seg, post, infos = [], [], []
        for s in range(0, len(keep), chunk):
            idx = np.zeros(chunk, dtype=np.int64)
            idx[: len(keep[s : s + chunk])] = keep[s : s + chunk]
            valid = np.arange(chunk) < len(keep[s : s + chunk])
            hot = tokens[torch.from_numpy(idx).to(net.device)]
            feats = out["token_features"][torch.from_numpy(idx).to(net.device)]
            logits, t_seg = timed(lambda: net.segment_logits(out, hot, feats))
            (density, sparse), t_post = timed(lambda: net.postprocess(out, hot, logits, valid))
            part, t_host = timed(lambda: net.hotspot_infos_from_outputs(
                data, idx, valid, rel, density, sparse=sparse))
            infos += part
            seg.append(t_seg)
            post.append(t_post + t_host)
        _, t_graph = timed(lambda: PharmacophoreModel.create(
            data.pdbblock, data.center, infos, size=net.grid_dim))
        runs.append(dict(parse=t_parse, voxelize=t_vox, trunk=t_trunk, heads=t_heads,
                         chunks=len(seg), segmentation_per_chunk=statistics.mean(seg),
                         postprocess_per_chunk=statistics.mean(post), graph=t_graph))
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def phase_modeling(dev, kernels: dict, card: str) -> None:
    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.network.convert import (
        random_distributions,
        save_torch_checkpoint,
        synthesize_torch_state_dict,
    )
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

    pdb = WORK / "pocket.pdb"
    info = write_synthetic_pocket(pdb, seed=POCKET_SEED)
    center = info["center"]
    ckpt = WORK / "ckpt.tar"
    save_torch_checkpoint(ckpt, synthesize_torch_state_dict(CKPT_SEED, CKPT_SCALE),
                          random_distributions(), config={"synthesized": [CKPT_SEED, CKPT_SCALE]})
    ref = PharmacoNet(weight_path=ckpt, voxelizer="reference", segmentation_precision="float32",
                      device=dev, verbose=False)
    data = ref.parse(pdb, center=center)
    log(f"  pocket: {info['num_atoms']} atoms in {info['num_residues']} residues, "
        f"{int(data.token_valid.sum())} tokens in the 64^3 box; checkpoint seed {CKPT_SEED} "
        f"scale {CKPT_SCALE}")
    kernels["voxelize_pallas"] = k6_entry(data, dev)
    split = run_probe("probe_voxelize", dev)["times"]  # K6's two launches apart
    kernels["voxelize_pallas"]["phase_stream_ms"] = {
        k: split[k]["stream_ms"] for k in ("bin", "tile", "store")}

    pm_path, wall, launches = run_modeling_cli(pdb, center, ckpt, WORK / "model", dev)
    kernels["voxelize_pallas"]["launches"] = launches
    pm = PharmacophoreModel.load(str(pm_path))
    log(f"  modeling CLI (default precisions): {wall:.3f} s wall per pocket on {card} "
        f"(network build + parse + model + .pm + visualization), {len(pm.nodes)} nodes, "
        f"{len(pm.node_clusters)} clusters, K6 launches {launches}")

    pm32_path, wall32, _ = run_modeling_cli(pdb, center, ckpt, WORK / "model32", dev,
                                            "--segmentation_precision", "float32")
    infos_ref = ref.create_density_maps(data)
    if not 16 <= len(infos_ref) <= 128:
        raise AssertionError(f"the pocket keeps {len(infos_ref)} hotspots, not 16-128")
    kern = PharmacoNet(weight_path=ckpt, segmentation_precision="float32", device=dev,
                       verbose=False)
    map_err = check_hotspots("K6 vs reference voxelizer", kern.create_density_maps(data),
                             infos_ref)
    node_err = check_pm("CLI --segmentation_precision float32 vs reference",
                        PharmacophoreModel.load(str(pm32_path)),
                        PharmacophoreModel.create(data.pdbblock, data.center, infos_ref))
    log(f"  float32 CLI ({wall32:.3f} s) vs PharmacoNet(voxelizer='reference'): "
        f"{len(infos_ref)} hotspots equal (type, position, score), max map diff {map_err:.3g}, "
        f"max node centre diff {node_err:.3g}")

    tf32 = PharmacoNet(weight_path=ckpt, device=dev, verbose=False)
    infos_tf32 = tf32.create_density_maps(data)
    by_pos = {h["hotspot_position"]: h["point_map"] for h in infos_ref}
    diffs = [float(np.abs(h["point_map"] - by_pos[h["hotspot_position"]]).max())
             for h in infos_tf32 if h["hotspot_position"] in by_pos]
    flips = sum(int(((h["point_map"] > 0) != (by_pos[h["hotspot_position"]] > 0)).sum())
                for h in infos_tf32 if h["hotspot_position"] in by_pos)
    log(f"  TF32 mask decoder (default) vs float32: {len(infos_tf32)} vs {len(infos_ref)} "
        f"hotspots, max map diff {max(diffs, default=0.0):.3g}, {flips} voxels cross the "
        f"0.5 threshold (not gated)")
    stages = modeling_stages(tf32, pdb, center)
    log("  stages of one pocket (host clock, median of 3, default precisions): "
        + ", ".join(f"{k} {v:.2f}" + ("" if k == "chunks" else " ms") for k, v in stages.items()))


# --------------------------------------------------------------------------
# Phase 8: the probe kernels P1-P4
# --------------------------------------------------------------------------
PROBES = ("probe_pallas_screen", "probe_fused_split", "probe_kernel_r3")


def probe_row_entries(pm, ligands, cuda, times: dict) -> dict:
    """P1 and P2 on the probe prep's untiled rows (the reference engine's
    half-octave bucket rounded up to whole tiles), with their times from
    the probe's run."""
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.probes import prep

    rb = prep.row_batch(pm, ligands)
    gi, lt = prep.gather_inputs(rb), prep.local_tables(rb)
    tables = [cuda(rb.muT), cuda(rb.invT), cuda(rb.winvT)]
    uv = cuda(lt.uv_loc)
    c, rows, tiles = gi.d_table.shape[1], rb.ns_t, rb.ns_t // 1024
    entries = valid_entries(tables[2])
    log(f"  P1/P2 rows: {rb.ns_real} real of {rows} ({tiles} tiles), NU {gi.d_table.shape[0]}, "
        f"tile node tables: max union {lt.max_union}, {lt.overflow} overflowing")
    p1_in = [cuda(gi.d_table), cuda(gi.slots), *tables]
    pos = cuda(lt.pos_blocks)
    out = {}
    for name, replaces, args, inputs, distance in (  # inputs: what the bound counts
        ("gaussian_phase_gather", "probes/probe_pallas_screen.py:139", p1_in, p1_in, False),
        ("gaussian_phase_local", "probes/probe_pallas_screen.py:235",
         [pos, uv[0], uv[1], *tables], [pos, uv, *tables], True),
    ):
        fn = lambda n=name, a=args: getattr(screen_cuda, n)(*a)  # noqa: E731
        plain = lambda n=name, a=args: getattr(screen_ref, n)(*a)  # noqa: E731
        got = fn()
        if not torch.equal(got[c:], plain()[c:]):
            raise AssertionError(f"{name}: pass counts differ from the plain version's")
        out[name] = kernel_entry(name, replaces, fn, plain, inputs, got,
                                 f32_ops(c, rows, entries, distance, ()), tiles,
                                 times=times[name])
    return out


def probe_tile_entries(pm, ligands, cuda, times: dict) -> dict:
    """P3's ablations and P4's variants on K1's tiles: each against its
    plain version, P3 full against K1's output and every P4 mode bit for
    bit; P4 ohbf16 bit for bit against its first design (rows, and
    distances, which must also be the prepack-time distances), timed
    beside it; the other times from the probes' runs."""
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.probes import prep
    from pharmaconet_tpu_torch.scoring.screen_tiles import tile_distances

    ti = prep.tiled_inputs(pm, ligands, threads=8)
    x = [cuda(a) for a in ti.arrays]
    d = (ti.depth1, ti.depth2)
    tiles, c = x[0].shape[0], x[0].shape[1] // 3
    rows, entries = tiles * 1024, valid_entries(x[2][:, 2])
    k1 = screen_cuda.score_tiles_fused_rows(*x, *d)
    out = {}
    for mode in screen_ref.ABLATIONS:
        noscan, noexp = mode in ("noscan", "gauss0"), mode in ("noexp", "gauss0")
        nohot = mode in ("nohot", "gauss0")
        name = f"score_tiles_fused_ablation[{mode}]"
        fn = lambda m=mode: screen_cuda.score_tiles_fused_ablation(*x, *d, m)  # noqa: E731
        got = fn()
        read = [x[0][:, 0, 0]] if nohot else x[:2]  # what the mode must read
        read += [x[2]] + ([] if noscan else [x[3]])
        ops = f32_ops(c, rows, entries, not nohot, () if noscan else d, 7 if noexp else 9)
        out[name] = kernel_entry(
            name, "probes/probe_fused_split.py:119", fn,
            lambda m=mode: screen_ref.score_tiles_fused_ablation(*x, *d, m), read, got,
            ops + (c * rows if noscan else 0), tiles, times=times[name])
        if mode == "full":
            err, _ = compare(f"{name} vs K1", got, k1)
            log(f"    full vs K1: max abs err {err:.3g}, bit-equal {torch.equal(got, k1)}")
    k1_ops = f32_ops(c, rows, entries, True, d)
    first = lambda: screen_cuda.score_tiles_ohbf16_baseline(*x, *d)  # noqa: E731
    for mode in screen_ref.VARIANTS:
        name = f"score_tiles_fused_variant[{mode}]"
        fn = lambda m=mode: screen_cuda.score_tiles_fused_variant(*x, *d, m)  # noqa: E731
        got = fn()
        out[name] = kernel_entry(
            name, "probes/probe_kernel_r3.py:137", fn,
            lambda m=mode: screen_ref.score_tiles_fused_variant(*x, *d, m), x, got, k1_ops,
            tiles, times=times[name],
            baseline=(first, ("score_tiles_ohbf16_baseline", dict(c=c))) if mode == "ohbf16"
            else None)
        if not torch.equal(got, k1):
            raise AssertionError(f"{name}: {int((got != k1).sum())} values differ from K1's")
        log(f"    {mode}: bit-equal to K1")
    _, dist = screen_cuda.score_tiles_fused_variant(*x, *d, "ohbf16", return_distances=True)
    _, first_dist = screen_cuda.score_tiles_ohbf16_baseline(*x, *d, return_distances=True)
    if not torch.equal(dist, first_dist):
        raise AssertionError(f"ohbf16: {int((dist != first_dist).sum())} distances differ "
                             "from its first design's")
    want = tile_distances(ti.pos_blocks, ti.uv, native=False)
    differ = int((dist.cpu().numpy() != want).sum())
    if differ:
        raise AssertionError(f"ohbf16: {differ} distances differ from the prepack-time ones")
    log(f"    ohbf16 distances: all {want.size} bit-equal to its first design's and to the "
        "prepack-time distances")
    entry = out["score_tiles_fused_variant[ohbf16]"]
    for key, design in (("occupancy_by_conformers", "score_tiles_fused_variant[ohbf16]"),
                        ("baseline_occupancy_by_conformers", "score_tiles_ohbf16_baseline")):
        entry[key] = {n: screen_cuda.kernel_resources(design, n)
                      for n in range(1, screen_cuda.MAX_CONFORMERS + 1)}
        log(f"    {design} registers / local bytes by C: " + ", ".join(
            f"{n}: {r['registers']}/{r['local_bytes']}" for n, r in entry[key].items()))
    return out


def run_probe(name: str, dev, *extra: str) -> dict:
    """One probe entry point on the device in a subprocess; returns its
    last line (launch counts and times)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"pharmaconet_tpu_torch.probes.{name}", "--device", str(dev),
         *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    log(f"  python -m pharmaconet_tpu_torch.probes.{name} ({time.perf_counter() - t0:.1f} s):")
    for line in lines[:-1]:
        log(f"    {line}")
    return json.loads(lines[-1])


def phase_probes(pm, ligands, dev, kernels: dict) -> None:
    from pharmaconet_tpu_torch.probes.timing import Times

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    counts, times = {}, {}
    for probe in PROBES:
        result = run_probe(probe, dev, "--ligands", str(N_BATCH))
        runs = {**result["launches"], **result["mode_launches"]}
        for name, n in runs.items():
            if n < 1:
                raise AssertionError(f"{probe} never launched {name}")
        log(f"    launches: {runs}")
        counts.update(runs)
        times.update({name: Times(**t) for name, t in result["times"].items()})
    entries = {**probe_row_entries(pm, ligands, cuda, times),
               **probe_tile_entries(pm, ligands, cuda, times)}
    torch.cuda.synchronize()
    for name, entry in entries.items():
        entry["launches"] = counts[name]
    kernels.update(entries)


# --------------------------------------------------------------------------
# Phase 9: SMILES input (the torch embedder on the card, K1 on the result)
# --------------------------------------------------------------------------
SMILES_N, SMILES_SEED, SMILES_CONFORMERS = 2048, 11, 8
# drug-like panel of tests/test_embed.py:23-35 (sildenafil: 33 heavy atoms, bucket 40)
EMBED_PANEL = {
    "benzene": "c1ccccc1", "hexane": "CCCCCC", "aspirin": "CC(=O)Oc1ccccc1C(=O)O",
    "caffeine": "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "naphthalene": "c1ccc2ccccc2c1",
    "atp-frag": "Nc1ncnc2c1ncn2C1OC(COP(=O)(O)O)C(O)C1O",
    "sildenafil": "CCCc1nn(C)c2c1nc(nc2=O)-c1cc(ccc1OCC)S(=O)(=O)N1CCN(C)CC1",
    "celecoxib": "Cc1ccc(cc1)-c1cc(nn1-c1ccc(cc1)S(N)(=O)=O)C(F)(F)F",
}
# the tolerances tests/test_torch_embed.py states for two runs of the
# program on the same draws: distances after MDS alone, after the
# refinement, the worst violation; a row whose 0.05 A stop moved by
# rounding must have converged in both, within 0.25 A, on at most 1% of rows
MDS_TOL, REFINED_TOL, WORST_TOL = 1e-4, 5e-3, 1e-3
STOP_TOL, FLIP_TOL, FLIP_SHARE = 0.05, 0.25, 0.01


def pdist(x: np.ndarray) -> np.ndarray:
    return np.linalg.norm(x[:, :, None] - x[:, None, :], axis=-1)


def rows_agree(name: str, xa, wa, xb, wb, iters: int) -> dict:
    """Two runs of embed_program on the same draws, against the tolerances
    above; raises outside them. Returns the largest differences."""
    dd = np.abs(pdist(xa) - pdist(xb)).max(axis=(1, 2))
    dw = np.abs(wa - wb)
    if iters == 0:
        if dd.max() > MDS_TOL:
            raise AssertionError(f"{name}: MDS distances {dd.max()} A apart")
        return dict(max_dist=float(dd.max()), moved=0)
    moved = ~((dd <= REFINED_TOL) & (dw <= WORST_TOL))
    if (not ((wa[moved] < STOP_TOL) & (wb[moved] < STOP_TOL)).all()
            or (dd[moved] > FLIP_TOL).any() or moved.sum() > FLIP_SHARE * len(dd)):
        raise AssertionError(f"{name}: {int(moved.sum())} of {len(dd)} rows apart "
                             f"(distances {dd[moved]}, worst {wa[moved]} vs {wb[moved]})")
    return dict(max_dist=float(dd[~moved].max()), max_worst=float(dw[~moved].max()),
                moved=int(moved.sum()), moved_max_dist=float(dd[moved].max(initial=0.0)))


def chunk_bounds(smiles: list[str]):
    from pharmaconet_tpu_torch.chem import embed
    from pharmaconet_tpu_torch.chem.smiles import parse_smiles

    mols = [parse_smiles(s) for s in smiles]
    nb = embed._bucket_n(max(m.num_atoms for m in mols))
    padded = [embed._pad_bounds(*embed._bounds(m), nb) for m in mols]
    return (torch.from_numpy(np.stack([p[0] for p in padded])),
            torch.from_numpy(np.stack([p[1] for p in padded])),
            torch.tensor([m.num_atoms for m in mols]), nb)


def device_busy(fn) -> dict:
    """Host wall ms of one synchronised call of `fn`, and the card's busy ms
    in it: the sum of its kernels' durations in a torch.profiler trace of a
    second call (one stream, so kernels do not overlap), their count, and
    the card's idle share of the wall time. None where the trace shows no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy" not in e.name and "Memset" not in e.name]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 if kernels else None
    return dict(wall_ms=wall, busy_ms=busy, kernels=len(kernels),
                idle_share=None if busy is None else 1.0 - busy / wall)


def embed_card_vs_cpu(dev) -> dict:
    """embed_program on the card and on the CPU with the same draws: one
    full chunk of the fragment library's bucket 20 (256 molecules x 8
    conformers) and the drug-like panel, bucket by bucket. Returns, for the
    full chunk, device_busy of 25 refinement steps (no host check) and of
    the whole program (600 steps)."""
    from pharmaconet_tpu_torch.chem import embed
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.chem.smiles import parse_smiles

    def bucket(smi: str) -> int:
        return embed._bucket_n(parse_smiles(smi).num_atoms)

    frags = [s for _, s in enumerate_fragment_smiles(SMILES_N, seed=SMILES_SEED)]
    cases = {"fragments bucket 20": [s for s in frags if bucket(s) == 20]
             [: embed._CHUNK_ROWS // SMILES_CONFORMERS]}
    for smi in EMBED_PANEL.values():
        cases.setdefault(f"panel bucket {bucket(smi)}", []).append(smi)
    split = None
    for name, smiles in cases.items():
        lo, up, nreal, nb = chunk_bounds(smiles)
        u = embed.draw_uniform(list(range(len(smiles))), 0, SMILES_CONFORMERS, nb, "cpu")
        args = [t.to(dev) for t in (lo, up, nreal, u)]
        if split is None:  # the full chunk, first
            x = torch.randn(len(smiles) * SMILES_CONFORMERS, nb, 3, device=dev)  # any start
            lo_r, up_r = (t.repeat_interleave(SMILES_CONFORMERS, 0) for t in args[:2])
            steps = 25
            split = dict(rows=x.shape[0], nb=nb, steps=steps, refine=device_busy(
                lambda: embed.refine(x, lo_r, up_r, iters=steps, check_every=1 << 30)),
                program=device_busy(lambda: embed.embed_program(*args, SMILES_CONFORMERS)))
            log(f"    card busy in {steps} refinement steps and in one program on "
                f"{x.shape[0]} rows (NB {nb}): {split}")
        for iters in (0, 600):
            xc, wc = (t.numpy() for t in embed.embed_program(lo, up, nreal, u, SMILES_CONFORMERS,
                                                             iters=iters))
            xg, wg = (t.cpu().numpy() for t in embed.embed_program(*args, SMILES_CONFORMERS,
                                                                   iters=iters))
            diff = rows_agree(f"{name}, {iters} steps", xg, wg, xc, wc, iters)
            log(f"    card vs CPU, {name} ({len(smiles)} molecules x {SMILES_CONFORMERS}, "
                f"NB {nb}), {iters} steps: {diff}")
    return split


def phase_smiles(dev, kernels: dict, card: str) -> dict:
    """C1: 64 fragment SMILES embedded on the card, scored through K1
    against GraphMatcher. C4: solo embeds bit-identical to the batched one.
    The card against the CPU on the same draws. Then 2048 fragment SMILES
    through `prepack --smiles --embed_backend torch` and `screening
    --smiles` (K1), every score against the reference engine on the
    prepacked library; the stages, steps and retries of the embedder, and
    the numpy backend's prepack of the same file on this host."""
    import os

    from pharmaconet_tpu_torch.chem import embed
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.cli import prepack, screening
    from pharmaconet_tpu_torch.ops import screen_cuda
    from pharmaconet_tpu_torch.probes.timing import time_ms
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, PackedModel
    from pharmaconet_tpu_torch.scoring.graph_match import GraphMatcher
    from pharmaconet_tpu_torch.scoring.library import load_library
    from pharmaconet_tpu_torch.scoring.parse_pool import iter_embedded
    from pharmaconet_tpu_torch.synthetic import make_synthetic_model

    out, t_part = {}, time.perf_counter()

    def part(name: str) -> None:  # host seconds of each part of the phase
        nonlocal t_part
        now = time.perf_counter()
        out.setdefault("part_s", {})[name] = now - t_part
        t_part = now

    model = make_synthetic_model(num_clusters=20, seed=3)  # probes/chip_ci.py's model
    entries = enumerate_fragment_smiles(64, seed=11)
    ligs = list(iter_embedded(entries, seed=2025, backend="torch", device=dev))
    if len(ligs) < 56:
        raise AssertionError(f"C1: only {len(ligs)} of 64 SMILES embedded")
    screen_cuda.reset_launch_counts()
    got = BatchScreener(model, device=dev).score_ligands([lig for _, lig in ligs])
    torch.cuda.synchronize()
    k1 = screen_cuda.LAUNCHES["score_tiles_fused_rows"]
    worst = check_scores("C1", dict(zip([n for n, _ in ligs], got)),
                         {n: GraphMatcher(model, lig).run() for n, lig in ligs})
    if k1 < 1:
        raise AssertionError("C1: the screener never launched K1")
    log(f"  C1: {len(ligs)} of 64 embedded on the card, K1 launches {k1}, "
        f"max |score - GraphMatcher| {worst:.3g}")
    part("C1")

    entries = enumerate_fragment_smiles(16, seed=23)
    batched = dict(iter_embedded(entries, seed=77, backend="torch", device=dev))
    for k in (0, 7, 15):
        name, smi = entries[k]
        solo = dict(iter_embedded([(name, smi)], seed=77 + k, backend="torch", device=dev))
        if (name in solo) != (name in batched) or (name in solo and not np.array_equal(
                solo[name].graph.atom_positions, batched[name].graph.atom_positions)):
            raise AssertionError(f"C4: {name}'s solo embed differs from the batched one")
    log(f"  C4: solo = batched bit for bit for k = 0, 7, 15 ({len(batched)} of 16 embedded)")
    part("C4")

    out["card_busy"] = embed_card_vs_cpu(dev)
    part("card_vs_cpu")

    # torch.linalg.qr against the port's batched Householder QR, one
    # subspace round's batch (2048 rows, NB 20, 3 columns)
    a = torch.randn(embed._CHUNK_ROWS, 20, 3, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    qr_ms = dict(thin_qr=time_ms(lambda: embed.thin_qr(a), 5),
                 torch_linalg_qr=time_ms(lambda: torch.linalg.qr(a)[0], 5))
    log(f"  QR of [2048, 20, 3] on {card}: {qr_ms}")
    part("qr")

    smi = WORK / "fragments.smi"
    smi.write_text("".join(f"{s} {n}\n" for n, s in enumerate_fragment_smiles(SMILES_N,
                                                                           seed=SMILES_SEED)))
    embed.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = prepack.main(prepack.build_parser().parse_args([
        "--smiles", str(smi), "-o", str(WORK / "fragments.npz"), "--embed_backend", "torch",
        "--device", str(dev), "--num_conformers", str(SMILES_CONFORMERS)]))
    wall = time.perf_counter() - t0
    stats = {k: (dict(v) if isinstance(v, dict) else v) for k, v in embed.STATS.items()}
    if rc != 0:
        raise AssertionError(f"prepack --smiles exited {rc}")
    packed, names = load_library(WORK / "fragments.npz")
    d = stats["dispatches"]
    out["prepack_torch"] = dict(
        smiles=SMILES_N, conformers=SMILES_CONFORMERS, wall_s=wall, smiles_per_s=SMILES_N / wall,
        embed_wall_s=stats["wall_s"], rest_s=wall - stats["wall_s"],
        embedded=len(names), rejected_share=1 - len(names) / SMILES_N, chunks=stats["chunks"],
        dispatches=d, rounds_per_chunk=stats["rounds"] / stats["chunks"],
        steps_per_dispatch=stats["steps"] / d,
        ms_per_dispatch={k: v / d for k, v in stats["ms"].items()},
        ms_per_step=stats["ms"]["refine"] / max(1, stats["steps"]))
    log(f"  prepack --smiles --embed_backend torch: {out['prepack_torch']}")
    part("prepack_torch")

    pm = PackedModel.from_model(model)
    model.save(str(WORK / "smiles_model.pm"))
    ref = dict(zip(names, BatchScreener(pm, engine="reference", device=dev).score_packed(packed)))
    screen_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = screening.main(screening.build_parser().parse_args([
        "-p", str(WORK / "smiles_model.pm"), "--smiles", str(smi), "-o", str(WORK / "smiles.csv"),
        "--device", str(dev), "--batch_size", str(N_BATCH)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in screen_cuda.LAUNCHES.items() if v}
    if rc != 0:
        raise AssertionError(f"screening --smiles exited {rc}")
    worst = check_scores("screening --smiles", read_csv(WORK / "smiles.csv"), ref)
    if counts.get("score_tiles_fused_rows", 0) < 1:
        raise AssertionError("screening --smiles never launched K1")
    kernels["score_tiles_fused_rows"]["launches_smiles"] = counts["score_tiles_fused_rows"]
    out["screen_smiles"] = dict(wall_s=wall, smiles_per_s=SMILES_N / wall, launches=counts,
                                max_abs_diff_reference=worst)
    log(f"  screening --smiles: {out['screen_smiles']}")
    part("screen_smiles")

    cpus = os.cpu_count() or 1
    t0 = time.perf_counter()
    rc = prepack.main(prepack.build_parser().parse_args([
        "--smiles", str(smi), "-o", str(WORK / "fragments_numpy.npz"), "--embed_backend", "numpy",
        "--cpus", str(cpus), "--device", str(dev), "--num_conformers", str(SMILES_CONFORMERS)]))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"prepack --smiles --embed_backend numpy exited {rc}")
    _, np_names = load_library(WORK / "fragments_numpy.npz")
    out["prepack_numpy"] = dict(cpus=cpus, wall_s=wall, smiles_per_s=SMILES_N / wall,
                                embedded=len(np_names))
    log(f"  prepack --smiles --embed_backend numpy --cpus {cpus}: {out['prepack_numpy']}")
    part("prepack_numpy")
    log(f"  phase parts (host s): {out['part_s']}")
    out.update(qr_ms=qr_ms, card=card)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[1] device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log(f"[2] build: {phase_build():.2f} s (nvcc + g++, in parallel)")

    from pharmaconet_tpu_torch.scoring.batch_screen import PackedModel
    from pharmaconet_tpu_torch.synthetic import make_synthetic_ligands, make_synthetic_model

    model = make_synthetic_model(num_clusters=20, seed=0)
    pm = PackedModel.from_model(model)
    log("[3] kernels vs plain versions on the card (headline batch)")
    kernels = phase_kernels(pm, make_synthetic_ligands(N_BATCH, num_conformers=4, seed=1), dev)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        log("[4] screening paths")
        packed, names, ref = phase_paths(model, pm, dev, kernels, smi)
        log("[5] -d route")
        phase_dir(model, dev)
        log("[6] stored route")
        phase_stored(pm, packed, names, ref, dev, kernels, smi)
        log(f"[6] {MANY_CONFORMERS} conformers per ligand: --library, v3 and v2 stores")
        phase_many_conformers(model, pm, dev, kernels, smi)
        log("[7] pocket modeling at full width")
        phase_modeling(dev, kernels, smi)
        log("[8] probe kernels P1-P4 (headline batch)")
        phase_probes(pm, make_synthetic_ligands(N_BATCH, num_conformers=4, seed=1), dev, kernels)
        log("[9] SMILES input: the torch embedder on the card, K1 on its output")
        print(json.dumps({"smiles": phase_smiles(dev, kernels, smi)}), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    order = ("score_tiles_fused_rows", "score_tiles_v3", "score_tiles_fused_dt",
             "score_blocks_fused", "gaussian_phase", "voxelize_pallas")
    probes = [k for k in kernels if k not in order]  # P1-P4, in phase 8's order
    print(json.dumps({"kernels": [kernels[k] for k in (*order, *probes)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
