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
 10. proxy   — the third product on phase 7's full-width trunk and
               checkpoint: feature extraction in process
               (api.get_pmnet_dev) and through its CLI (.npz, .pt), the
               CLI's arrays against the in-process ones; both docking
               proxies (TacoGFN, SBDDReward) at the published widths from
               _init_random: get_cache fused against unfused, the card's
               cache against the CPU's on the same pyramid, a 3-pocket
               get_cache_database (seeds 0-2, pockets/s), then 16 hotspots
               x 2048 fragment SMILES (phase 9's list): scores against the
               CPU's, solo = batched, an invalid SMILES scoring 0.0
               (SBDDReward), tensorfloat32 and bfloat16 within the JAX
               tests' bounds of float32, host ms of featurization and of
               batch_graphs + copy, device ms of the forward, molecules/s
               and peak memory; the modeling CLI's ligand detection
               (--ligand_id, --all) against --ref_ligand on the ligand file
               it wrote; K6's launch count reset just before and read just
               after every path: once per pocket; one {"proxy": ...} line
 11. train   — serving at scale and training at full width: both float32
               proxies of phase 10 (16-hotspot caches) behind
               ShardedProxyScorer on [cuda:0], scoring_iter over 8192
               fragment SMILES in batches of 2048 against a loop of
               scoring_list (scores against the largest reference value,
               molecules/s and the idle share of each); ShardedCacheBuilder
               over phase 10's 3 pockets and a missing file, equal to the
               serial get_cache_database element by element, pockets/s of
               each; the affinity-head Trainer at the published widths
               (hidden 128, 4 convolutions) on phase 7's trunk and
               checkpoint over 8 synthetic pockets (seeds 0-7) x 64 fragment
               SMILES, 6 iterations of batch 4 with centre noise 3 A: finite
               losses, K6 once per item fetched, one step on the card against
               the CPU, resume then one step against the uninterrupted run,
               last.npz reloaded, s per iteration, the item split, the step's
               busy ms and idle share, peak memory; the detector's train
               step at the published width on make_dummy_batch(2, 64, 16),
               5 steps (ms per step, peak memory, the profiler's split) and
               one micro step on the card against the CPU; one {"train": ...}
               line
 12. shard   — sharded screening and modeling on meshes that name cuda:0
               one to three times (one card): ShardedScreener on [cuda:0]
               and [cuda:0] * 2 in each live mapping (K1; native_pack=False,
               K5 and the torch scans; the reference engine) on the
               headline batch, and through score_stored_group on phase 6's
               v3 (4 batches, leaf buckets) and v2 (2 batches) stores in
               groups of 1 and 2, every score against BatchScreener and
               each path's launch counts reset just before and read just
               after; ligands/s of BatchScreener and both meshes, timed in
               turns; the screening CLI with its mesh function patched to
               [cuda:0] * 2 on phase 4's --library and phase 6's v3
               --library_tiles against those phases' CSVs; ShardedModeler
               on [cuda:0] * 3 over phase 10's three pockets (seeds 0-2)
               and ShardedSegmenter on [cuda:0] * 3 on phase 10's
               187-hotspot pocket (get_pmnet_dev), both with phase 7's
               checkpoint, map for map against the single path, K6 once
               per pocket, pockets/s and ms of each in turns; the modeling
               CLI on pocket 0 with two HET ligands: --all, --shard --all
               (mesh patched to [cuda:0] * 3) and --profile DIR --all, the
               .pm files equal and each trace holding CUDA kernel events;
               one {"shard": ...} line
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
counts on the 12-conformer routes, K6 `launches_proxy` (phase 10's total)
and `launches_proxy_paths` (per path), `launches_train` and
`launches_train_paths` (phase 11's). K1, K2, K3, K5 and K6 add
`launches_shard` (phase 12's).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pickle
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


def device_busy(fn, top: int = 0) -> dict:
    """Host wall ms of one synchronised call of `fn`, and the card's busy ms
    in it: the sum of its kernels' durations in a torch.profiler trace of a
    second call (one stream, so kernels do not overlap), their count, and
    the card's idle share of the wall time. None where the trace shows no
    kernel. `top` > 0 adds the `top` kernel names with the most busy ms
    (name cut to 90 characters, ms, launches)."""
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
    out = dict(wall_ms=wall, busy_ms=busy, kernels=len(kernels),
               idle_share=None if busy is None else 1.0 - busy / wall)
    if top:
        by_name: dict[str, list] = {}
        for e in kernels:
            slot = by_name.setdefault(e.name[:90], [0.0, 0])
            slot[0] += e.time_range.elapsed_us() / 1e3
            slot[1] += 1
        out["top_kernels"] = sorted(([n, ms, c] for n, (ms, c) in by_name.items()),
                                    key=lambda r: -r[1])[:top]
    return out


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


# --------------------------------------------------------------------------
# Phase 10: feature extraction and the docking proxies
# --------------------------------------------------------------------------
PROXY_HOTSPOTS, PROXY_SEEDS = 16, {"TacoGFN": 7, "SBDDReward": 8}
PYRAMID_SHAPES = [(1, d, d, d, 96) for d in (4, 8, 16, 32, 64)]  # the published trunk's
FEATURE_TOL = 1e-5  # CLI arrays against in-process ones (atol and rtol)
# the JAX tests' bounds of a precision against float32 (tests/test_proxy.py)
PRECISION_TOL = {"tensorfloat32": (5e-3, 1e-3), "bfloat16": (5e-2, 0.3)}


def k6_count(fn):
    """(fn's result, K6 launches it made): counts reset just before, read
    just after."""
    from pharmaconet_tpu_torch.ops import voxelize_cuda

    voxelize_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, voxelize_cuda.LAUNCHES["voxelize_pallas"]


def once_per_pocket(name: str, launches: int, pockets: int = 1) -> None:
    if launches != pockets:
        raise AssertionError(f"{name} launched voxelize_pallas {launches} times for "
                             f"{pockets} pocket(s)")


def host_s(fn, reps: int = 3):
    """(last result, median host seconds), each call ending in a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


class Checks:
    """Phases 10's and 11's comparisons: every one runs and is recorded
    (largest difference, largest reference magnitude); `raise_misses` fails
    the phase on any miss at its end, so one run shows every disagreement.

    Two forms. Element by element (`np.allclose`) where both sides run the
    same kernels in the same order (fused vs unfused, solo vs batched, the
    database vs get_cache). Against the largest reference value
    (|got - want| <= atol + rtol * max|want|) where the summation order or
    the precision differs (card vs CPU, TF32 and bf16 vs f32): the error of
    a sum is relative to the magnitudes summed, not to the result, and a
    random-init TacoGFN sums pair energies of thousands into scores near
    zero. Both forms are recorded (`elementwise`)."""

    def __init__(self, phase: str):
        self.phase = phase
        self.misses: list[str] = []
        self.seen: dict[str, dict] = {}

    def close(self, name: str, got, want, rtol=RTOL, atol=ATOL, scaled=False) -> float:
        """Arrays (or tuples of arrays and numbers) within rtol/atol, element
        by element or (`scaled`) against each array's largest value."""
        pairs = list(zip(got, want, strict=True)) if isinstance(want, tuple) else [(got, want)]
        worst = scale = 0.0
        ok = elementwise = True
        for a, b in pairs:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if a.shape != b.shape or not np.isfinite(a).all():
                ok = elementwise = False
                continue
            if a.size:
                err, ref = float(np.abs(a - b).max()), float(np.abs(b).max())
                worst, scale = max(worst, err), max(scale, ref)
                elementwise &= bool(np.allclose(a, b, rtol=rtol, atol=atol))
                ok &= err <= atol + rtol * ref if scaled else elementwise
        self.seen[name] = dict(max_abs_err=worst, max_abs_ref=scale, elementwise=elementwise)
        if not ok:
            self.misses.append(f"{name}: max abs err {worst:.3g} (reference up to {scale:.3g}, "
                               f"rtol {rtol}, atol {atol}, "
                               f"{'scaled' if scaled else 'elementwise'})")
        return worst

    def true(self, name: str, ok: bool, detail: str) -> None:
        if not ok:
            self.misses.append(f"{name}: {detail}")

    def raise_misses(self) -> None:
        if self.misses:
            raise AssertionError(f"{self.phase} misses:\n  " + "\n  ".join(self.misses))


def proxy_split(proxy, cache, smiles: list[str]) -> dict:
    """One 2048-SMILES batch's parts, median of 3: host ms of the C++
    featurization and of batch_graphs + the copy to the card, device ms of
    the forward (CUDA events), and the whole scoring_list call."""
    from pharmaconet_tpu_torch.proxy.data import batch_graphs, half_octave, smi2graph_list
    from pharmaconet_tpu_torch.proxy.tacogfn import graph_batch_to_arrays

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        graphs = smi2graph_list(smiles)
        t1 = time.perf_counter()
        batch = batch_graphs(graphs, num_graphs_pad=half_octave(len(graphs)))
        arrays = graph_batch_to_arrays(batch, proxy.categorical, device=proxy.device)
        args = proxy._forward_inputs(cache, arrays)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        proxy._forward(*args)
        end.record()
        end.synchronize()
        _, total = host_s(lambda: proxy._scoring_list(cache, smiles), reps=1)
        runs.append(dict(featurize_ms=(t1 - t0) * 1e3, batch_and_copy_ms=(t2 - t1) * 1e3,
                         forward_device_ms=start.elapsed_time(end), scoring_list_ms=total * 1e3,
                         atoms=int(batch.atom_valid.sum()), atoms_padded=len(batch.atom_valid)))
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    out["mol_per_s"] = len(smiles) / (out["scoring_list_ms"] / 1e3)
    return out


def phase_proxy(dev, kernels: dict, card: str) -> dict:
    """Feature extraction (get_pmnet_dev and the CLI, .npz and .pt), both
    docking proxies at the published widths (get_cache fused and not, the
    card against the CPU, a 3-pocket cache database, 2048-SMILES scoring in
    each precision) and the modeling CLI's ligand detection, on the
    full-width trunk of phase 7; K6 counted on every path."""
    from pharmaconet_tpu_torch import api
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.cli import feature_extraction as fe_cli
    from pharmaconet_tpu_torch.cli.modeling import build_parser as modeling_parser
    from pharmaconet_tpu_torch.cli.modeling import main as modeling_main
    from pharmaconet_tpu_torch.network.convert import (
        random_distributions,
        save_torch_checkpoint,
        synthesize_torch_state_dict,
    )
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy
    from pharmaconet_tpu_torch.synthetic import append_het_ligands, write_synthetic_pocket

    out: dict = {"card": card}
    k6: dict[str, int] = {}
    check = Checks("phase 10")
    pockets = []
    for seed in range(3):
        pdb = WORK / f"proxy_pocket{seed}.pdb"
        pockets.append((pdb, write_synthetic_pocket(pdb, seed=seed)["center"]))
    pdb, center = pockets[0]
    ckpt = WORK / "proxy_ckpt.tar"
    save_torch_checkpoint(ckpt, synthesize_torch_state_dict(CKPT_SEED, CKPT_SCALE),
                          random_distributions(), config={"synthesized": [CKPT_SEED, CKPT_SCALE]})

    # 1. feature extraction: in process, then the CLI (.npz, .pt)
    net = api.get_pmnet_dev(device=dev, weight_path=ckpt)
    (feats, infos), k6["feature_extraction"] = k6_count(
        lambda: net.feature_extraction(pdb, center=center))
    once_per_pocket("feature_extraction", k6["feature_extraction"])
    _, out["feature_extraction_s"] = host_s(lambda: net.feature_extraction(pdb, center=center))
    if [f.shape for f in feats] != PYRAMID_SHAPES or len(infos) < PROXY_HOTSPOTS:
        raise AssertionError(f"feature extraction: shapes {[f.shape for f in feats]}, "
                             f"{len(infos)} hotspots")
    x, y, z = center
    cli_err = 0.0
    for suffix in ("npz", "pt"):
        args = fe_cli.build_parser().parse_args([
            "-p", str(pdb), "--center", str(x), str(y), str(z), "-o",
            str(WORK / f"features.{suffix}"), "--weight_path", str(ckpt), "--device", str(dev)])
        (rc, wall), k6[f"feature_extraction_cli_{suffix}"] = k6_count(
            lambda: host_s(lambda: fe_cli.main(args), reps=1))
        once_per_pocket(f"feature_extraction CLI .{suffix}", k6[f"feature_extraction_cli_{suffix}"])
        out[f"feature_extraction_cli_{suffix}_s"] = wall
        if rc != 0:
            raise AssertionError(f"feature_extraction CLI .{suffix} exited {rc}")
    saved = np.load(WORK / "features.npz")
    pt_feats, pt_infos = torch.load(WORK / "features.pt", weights_only=False)
    if int(saved["num_hotspots"]) != len(infos) or len(pt_infos) != len(infos):
        raise AssertionError(f"feature_extraction CLI: {int(saved['num_hotspots'])} / "
                             f"{len(pt_infos)} hotspots, in process {len(infos)}")
    for i, f in enumerate(feats):
        for got in (saved[f"feature_{i}"], pt_feats[i].numpy()):
            cli_err = max(cli_err, float(np.abs(got - f).max()))
            if not np.allclose(got, f, rtol=FEATURE_TOL, atol=FEATURE_TOL):
                raise AssertionError(f"feature_extraction CLI: level {i} differs")
    for i, info in enumerate(infos):
        if tuple(saved[f"hotspot_{i}_position"]) != info["hotspot_position"] or \
                str(saved[f"hotspot_{i}_nci_type"]) != info["nci_type"]:
            raise AssertionError(f"feature_extraction CLI: hotspot {i} differs")
        cli_err = max(cli_err, float(np.abs(saved[f"hotspot_{i}_feature"]
                                            - info["hotspot_feature"]).max()))
    out["feature_extraction_cli_max_abs_err"] = cli_err
    log(f"  feature extraction: {len(infos)} hotspots, {out['feature_extraction_s']:.3f} s per "
        f"pocket in process, CLI .npz {out['feature_extraction_cli_npz_s']:.3f} s / .pt "
        f"{out['feature_extraction_cli_pt_s']:.3f} s (network build included), CLI arrays "
        f"within {cli_err:.3g} of in-process")

    # 2.-4. both proxies at the published widths
    smiles = [s for _, s in enumerate_fragment_smiles(SMILES_N, seed=SMILES_SEED)]
    for name, cls in (("TacoGFN", TacoGFN_Proxy), ("SBDDReward", SBDDReward_Proxy)):
        res: dict = {}
        proxy = cls(device=dev, pmnet_kwargs={"weight_path": ckpt})
        proxy._init_random(PROXY_SEEDS[name])
        cpu = cls(device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in proxy.model.state_dict().items()})

        fused, k6[f"{name}_get_cache_fused"] = k6_count(lambda: proxy.get_cache(pdb, center=center))
        unfused, k6[f"{name}_get_cache_unfused"] = k6_count(
            lambda: proxy.get_cache(pdb, center=center, fused=False))
        once_per_pocket(f"{name} get_cache(fused=True)", k6[f"{name}_get_cache_fused"])
        once_per_pocket(f"{name} get_cache(fused=False)", k6[f"{name}_get_cache_unfused"])
        res["fused_vs_unfused_max_abs_err"] = check.close(f"{name} fused vs unfused", fused,
                                                          unfused)
        _, res["get_cache_fused_ms"] = host_s(lambda: proxy.get_cache(pdb, center=center))
        _, res["get_cache_unfused_ms"] = host_s(
            lambda: proxy.get_cache(pdb, center=center, fused=False))
        res["get_cache_fused_ms"] *= 1e3
        res["get_cache_unfused_ms"] *= 1e3
        card_cache = proxy._get_cache(feats, infos)
        res["cache_card_vs_cpu_max_abs_err"] = check.close(
            f"{name} cache card vs CPU", card_cache, cpu._get_cache(feats, infos), scaled=True)

        if name == "SBDDReward":  # 3. the cache database
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            db, k6["cache_database_3_pockets"] = k6_count(lambda: proxy.get_cache_database(
                {f"pocket{i}": p for i, p in enumerate(pockets)}, verbose=False))
            wall = time.perf_counter() - t0
            once_per_pocket("get_cache_database", k6["cache_database_3_pockets"], 3)
            if sorted(db) != ["pocket0", "pocket1", "pocket2"]:
                raise AssertionError(f"get_cache_database built {sorted(db)}")
            check.close("cache database vs get_cache", db["pocket0"], fused)
            out["cache_database"] = dict(pockets=3, wall_s=wall, pockets_per_s=3 / wall)
            log(f"  SBDDReward get_cache_database: 3 pockets in {wall:.3f} s "
                f"({3 / wall:.3f} pockets/s), K6 launches 3")

        # 4. scoring at bench.py's proxy shape: 16 hotspots, 2048 SMILES
        cache = proxy._get_cache(feats, infos[:PROXY_HOTSPOTS])
        want = proxy._scoring_list(cache, smiles)  # float32, also the warm-up
        res["scores_card_vs_cpu_max_abs_err"] = check.close(
            f"{name} 2048 scores card vs CPU", want, cpu._scoring_list(cache, smiles),
            scaled=True)
        solo = np.concatenate([proxy._scoring_list(cache, [s]) for s in smiles[:16]])
        res["solo_vs_batched_max_abs_err"] = check.close(
            f"{name} solo vs batched", solo, proxy._scoring_list(cache, smiles[:16]),
            rtol=2e-4, atol=1e-5)
        if name == "SBDDReward":
            mixed = proxy._scoring_list(cache, [smiles[0], "c11", smiles[1]])
            check.true("SBDDReward invalid SMILES", mixed[1] == 0.0, f"scored {mixed[1]}")
            check.close("SBDDReward with an invalid SMILES", mixed[[0, 2]], want[:2],
                        rtol=2e-4, atol=1e-5)
        torch.cuda.reset_peak_memory_stats(dev)
        res["float32"] = proxy_split(proxy, cache, smiles)
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        res["float32_busy"] = device_busy(lambda: proxy._scoring_list(cache, smiles), top=6)
        for precision, (rtol, atol) in PRECISION_TOL.items():
            other = cls(device=dev, precision=precision)
            other.load_state_dict(proxy.model.state_dict())
            got = other._scoring_list(cache, smiles)
            res[f"{precision}_vs_float32_max_abs_err"] = check.close(
                f"{name} {precision} vs float32", got, want, rtol=rtol, atol=atol, scaled=True)
            res[precision] = proxy_split(other, cache, smiles)
        out[name] = res
        log(f"  {name}: get_cache {res['get_cache_fused_ms']:.1f} ms fused / "
            f"{res['get_cache_unfused_ms']:.1f} unfused per pocket (K6 once each), fused vs "
            f"unfused {res['fused_vs_unfused_max_abs_err']:.3g}, card vs CPU cache "
            f"{res['cache_card_vs_cpu_max_abs_err']:.3g}, 2048 scores "
            f"{res['scores_card_vs_cpu_max_abs_err']:.3g}; peak {res['peak_memory_gib']:.2f} GiB")
        for precision in ("float32", *PRECISION_TOL):
            log(f"    {precision}: {res[precision]}")
        log(f"    float32 scoring_list on the card (torch.profiler): {res['float32_busy']}")
        del proxy, other, cpu
        torch.cuda.empty_cache()

    # 5. the modeling CLI's ligand detection
    het = WORK / "proxy_complex.pdb"
    het.write_text(pdb.read_text())
    append_het_ligands(het, [("LIG", "A", 901, center)], {"LIG": "SMOKE LIGAND"})
    runs = {}
    for label, extra in (("ligand_id", ["--ligand_id", "LIG"]), ("all", ["--all"]),
                         ("ref_ligand", ["--ref_ligand", str(WORK / "cli_ligand_id" /
                                                          "cx_B_LIG.pdb")])):
        args = modeling_parser().parse_args([
            "-p", str(het), "--prefix", "cx", "--out_dir", str(WORK / f"cli_{label}"),
            "--weight_path", str(ckpt), "--device", str(dev), *extra])
        (rc, wall), k6[f"modeling_cli_{label}"] = k6_count(
            lambda: host_s(lambda: modeling_main(args), reps=1))
        once_per_pocket(f"modeling CLI {label}", k6[f"modeling_cli_{label}"])
        if rc != 0:
            raise AssertionError(f"modeling CLI {label} exited {rc}")
        pm = sorted((WORK / f"cli_{label}").glob("*_model.pm"))
        if len(pm) != 1:
            raise AssertionError(f"modeling CLI {label} wrote {[p.name for p in pm]}")
        runs[label] = (pm[0], wall)
    want_pm = PharmacophoreModel.load(str(runs["ref_ligand"][0]))
    detect = {}
    for label in ("ligand_id", "all"):
        err = check_pm(f"modeling CLI {label} vs --ref_ligand",
                       PharmacophoreModel.load(str(runs[label][0])), want_pm)
        if err > FEATURE_TOL:
            raise AssertionError(f"modeling CLI {label}: node centres {err} from --ref_ligand's")
        detect[label] = dict(wall_s=runs[label][1], max_node_centre_diff=err,
                             bytes_equal=runs[label][0].read_bytes() ==
                             runs["ref_ligand"][0].read_bytes())
    out["modeling_detection"] = detect
    log(f"  modeling CLI ligand detection: {detect} (--ref_ligand "
        f"{runs['ref_ligand'][1]:.3f} s), {len(want_pm.nodes)} nodes")

    out["k6_launches"] = k6
    out["comparisons"] = check.seen
    kernels["voxelize_pallas"]["launches_proxy"] = sum(k6.values())
    kernels["voxelize_pallas"]["launches_proxy_paths"] = k6
    log(f"  comparisons: {check.seen}")
    check.raise_misses()
    return out


# --------------------------------------------------------------------------
# Phase 11: serving at scale and training
# --------------------------------------------------------------------------
SERVE_N, SERVE_BATCH = 8192, 2048
TRAIN_POCKETS, TRAIN_LIGANDS, TRAIN_SEED = 8, 64, 5
DETECTOR_BATCH, DETECTOR_TOKENS, DETECTOR_STEPS = 2, 16, 5
MICRO = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window=2, token_feature_dim=16)
# one step on the card against the CPU from the same parameters and inputs:
# the loss within rtol 1e-5; the gradients no further from the CPU's float64
# gradient than STEP_GRAD_FACTOR times the CPU's own float32 gradient is
# (the worst leaf of each, relative to the leaf's largest entry), plus
# 1e-6: both sum in f32 in different orders (the card with atomics in
# index_add_ and the gathers' backward), and how far that moves a gradient
# depends on how much its terms cancel, which the float64 run measures;
# after the update, parameters within 1e-6 where the gradient is settled
# (at least 1e-3 of its leaf's largest and 1e-6). Adam's first step moves
# every entry by lr * g / (|g| + eps), about lr whatever |g|, so an entry
# whose gradient is rounding noise may move either way: those are counted,
# not held.
STEP_LOSS_RTOL, STEP_GRAD_FACTOR, STEP_PARAM_TOL = 1e-5, 10.0, 1e-6


def as_float64(tree):
    """Floating tensors of a (nested) tuple/list as float64; the rest as is."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_float64(t) for t in tree)
    return tree


def worst_leaf_rel(grads: dict, ref: dict) -> float:
    """The largest |grads - ref| of any leaf over that leaf's largest |ref|."""
    worst = 0.0
    for key, r in ref.items():
        if r is not None and grads[key] is not None and float(r.abs().max()) > 0:
            worst = max(worst, float((grads[key].detach().cpu().double() - r).abs().max())
                        / float(r.abs().max()))
    return worst


def max_param_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max(float((p.detach().cpu() - q.detach().cpu()).abs().max())
               for (_, p), (_, q) in zip(a.named_parameters(), b.named_parameters(), strict=True))


def step_card_vs_cpu(check: Checks, name: str, card: tuple, cpu: tuple, ref: dict) -> dict:
    """card, cpu: (loss, {name: grad}, model after one step from fresh
    optimizer state); ref: the CPU's float64 gradients from the same
    parameters. Holds them as STEP_* says; returns the differences."""
    (loss_d, grads_d, model_d), (loss_h, grads_h, model_h) = card, cpu
    check.close(f"{name} loss card vs CPU", loss_d, loss_h, rtol=STEP_LOSS_RTOL, atol=0.0)
    for key, gh in grads_h.items():
        check.true(f"{name} gradient {key}", (gh is None) == (grads_d[key] is None),
                   "reached on one device only")
    card_rel, cpu_rel = worst_leaf_rel(grads_d, ref), worst_leaf_rel(grads_h, ref)
    check.true(f"{name} gradients card vs float64",
               card_rel <= STEP_GRAD_FACTOR * cpu_rel + 1e-6,
               f"card {card_rel:.3g}, CPU float32 {cpu_rel:.3g} of a leaf's largest")
    params_d, params_h = dict(model_d.named_parameters()), dict(model_h.named_parameters())
    settled_diff, unsettled = 0.0, 0
    for key, gh in grads_h.items():
        if gh is None:
            continue
        settled = gh.abs() >= max(1e-3 * float(gh.abs().max()), 1e-6)
        diff = (params_d[key].detach().cpu() - params_h[key].detach()).abs()
        if settled.any():
            settled_diff = max(settled_diff, float(diff[settled].max()))
        unsettled += int((~settled).sum())
    check.true(f"{name} settled parameters card vs CPU", settled_diff <= STEP_PARAM_TOL,
               f"{settled_diff:.3g} apart")
    return dict(loss=[loss_d, loss_h], grad_rel_card_vs_f64=card_rel,
                grad_rel_cpu_f32_vs_f64=cpu_rel, grad_rel_card_vs_cpu=worst_leaf_rel(
                    grads_d, {k: None if g is None else g.double() for k, g in grads_h.items()}),
                settled_param_max_diff=settled_diff, unsettled_entries=unsettled,
                param_max_diff=max_param_diff(model_d, model_h))


def phase_serve(dev, ckpt: Path, pockets: list, check: Checks, k6: dict) -> dict:
    """Both float32 proxies of phase 10 (16-hotspot caches) behind
    ShardedProxyScorer on [cuda:0]: scoring_iter over 8192 fragment SMILES
    in batches of 2048 against a loop of scoring_list; then
    ShardedCacheBuilder over phase 10's 3 pockets and a missing file
    against the serial get_cache_database."""
    from pharmaconet_tpu_torch import api
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.parallel.proxy import ShardedCacheBuilder, ShardedProxyScorer
    from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy

    out: dict = {}
    net = api.get_pmnet_dev(device=dev, weight_path=ckpt)
    pdb, center = pockets[0]
    (feats, infos), k6["serve_feature_extraction"] = k6_count(
        lambda: net.feature_extraction(pdb, center=center))
    once_per_pocket("phase 11 feature_extraction", k6["serve_feature_extraction"])
    smiles = [s for _, s in enumerate_fragment_smiles(SERVE_N, seed=SMILES_SEED)]
    batches = [smiles[i:i + SERVE_BATCH] for i in range(0, SERVE_N, SERVE_BATCH)]
    info = {f"pocket{i}": p for i, p in enumerate(pockets[:3])}
    info["missing"] = (WORK / "absent.pdb", center)
    for name, cls in (("TacoGFN", TacoGFN_Proxy), ("SBDDReward", SBDDReward_Proxy)):
        res: dict = {}
        proxy = cls(device=dev)
        proxy._init_random(PROXY_SEEDS[name])
        proxy.pmnet = net
        proxy.put_cache("target", proxy._get_cache(feats, infos[:PROXY_HOTSPOTS]))
        scorer = ShardedProxyScorer(proxy, mesh=[dev])

        def loop():
            return [proxy.scoring_list("target", b) for b in batches]

        def stream():
            return list(scorer.scoring_iter("target", smiles, batch_size=SERVE_BATCH))

        want = np.concatenate(loop())  # also the warm-up
        got = stream()
        check.true(f"{name} scoring_iter batches", [len(c) for c in got] == [SERVE_BATCH] * 4,
                   f"lengths {[len(c) for c in got]}")
        res["scoring_iter_vs_scoring_list_max_abs_err"] = check.close(
            f"{name} scoring_iter vs scoring_list", np.concatenate(got), want, scaled=True)
        _, t_loop = host_s(loop)
        _, t_iter = host_s(stream)
        res.update(scoring_list_mol_per_s=SERVE_N / t_loop, scoring_iter_mol_per_s=SERVE_N / t_iter,
                   speedup=t_loop / t_iter, scoring_list_busy=device_busy(loop),
                   scoring_iter_busy=device_busy(stream))

        builder = ShardedCacheBuilder(proxy, mesh=[dev])
        serial, k6[f"{name}_serial_database"] = k6_count(
            lambda: proxy.get_cache_database(dict(info), verbose=False))
        sharded, k6[f"{name}_sharded_database"] = k6_count(
            lambda: builder.get_cache_database(dict(info), verbose=False))
        once_per_pocket(f"{name} serial database", k6[f"{name}_serial_database"], 3)
        once_per_pocket(f"{name} ShardedCacheBuilder", k6[f"{name}_sharded_database"], 3)
        check.true(f"{name} database keys", sorted(sharded) == sorted(serial) == sorted(info)[1:],
                   f"sharded {sorted(sharded)}, serial {sorted(serial)}")
        for key in set(serial) & set(sharded):
            check.close(f"{name} ShardedCacheBuilder {key} vs serial", sharded[key], serial[key],
                        rtol=0.0, atol=0.0)
        _, t_serial = host_s(lambda: proxy.get_cache_database(dict(info), verbose=False), reps=2)
        _, t_sharded = host_s(lambda: builder.get_cache_database(dict(info), verbose=False),
                              reps=2)
        res.update(serial_pockets_per_s=3 / t_serial, sharded_pockets_per_s=3 / t_sharded)
        out[name] = res
        log(f"  {name}: scoring_iter {res['scoring_iter_mol_per_s']:.0f} molecules/s against "
            f"scoring_list {res['scoring_list_mol_per_s']:.0f} ({res['speedup']:.3f}x), idle "
            f"{res['scoring_iter_busy']['idle_share']:.3f} against "
            f"{res['scoring_list_busy']['idle_share']:.3f}; ShardedCacheBuilder "
            f"{res['sharded_pockets_per_s']:.3f} pockets/s against serial "
            f"{res['serial_pockets_per_s']:.3f} (K6 once per good pocket)")
        del proxy, scorer, builder
        torch.cuda.empty_cache()
    return out


def train_files(root: Path) -> Path:
    """8 synthetic pockets (seeds 0-7), 64 fragment SMILES each with seeded
    affinities in [-12, 0], and the trainer's config files; returns the
    config path's directory."""
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

    (root / "proteins").mkdir(parents=True)
    rng = np.random.default_rng(TRAIN_SEED)
    frags = [s for _, s in enumerate_fragment_smiles(TRAIN_POCKETS * TRAIN_LIGANDS,
                                                      seed=TRAIN_SEED)]
    lines, ligands = [], {}
    for i in range(TRAIN_POCKETS):
        center = write_synthetic_pocket(root / "proteins" / f"pocket{i}.pdb", seed=i)["center"]
        lines.append(",".join([f"pocket{i}", *map(str, center)]))
        ligands[f"pocket{i}"] = [(f"l{j}", frags[i * TRAIN_LIGANDS + j],
                                  float(rng.uniform(-12, 0))) for j in range(TRAIN_LIGANDS)]
    (root / "info.csv").write_text("\n".join(lines))
    (root / "codes.txt").write_text("\n".join(f"pocket{i}" for i in range(TRAIN_POCKETS)))
    with open(root / "ligands.pkl", "wb") as f:
        pickle.dump(ligands, f)
    return root


def train_config(root: Path):
    from pharmaconet_tpu_torch.training import Config

    config = Config()
    config.log_dir = str(root / "log")
    config.data.protein_info_path = str(root / "info.csv")
    config.data.train_protein_code_path = str(root / "codes.txt")
    config.data.protein_dir = str(root / "proteins")
    config.data.ligand_path = str(root / "ligands.pkl")
    config.model.hidden_dim, config.model.ligand_num_convs = 128, 4
    t = config.train
    t.batch_size, t.split_ratio, t.center_noise, t.max_iterations = 4, 0.75, 3.0, 6
    t.val_every = t.save_every = 3
    t.log_every = t.print_every = 1
    return config


def phase_trainer(dev, ckpt: Path, check: Checks, k6: dict) -> dict:
    """The affinity-head trainer at the published widths (hidden 128, 4
    convolutions) on the full-width trunk: fit over 8 pockets, then one
    step on the card against the CPU, resume then one step against the
    uninterrupted run, and last.npz reloaded."""
    from pharmaconet_tpu_torch import api
    from pharmaconet_tpu_torch.ops import voxelize_cuda
    from pharmaconet_tpu_torch.training import Trainer
    from pharmaconet_tpu_torch.training.convert import load_checkpoint
    from pharmaconet_tpu_torch.training.train_step import apply_updates

    root = train_files(WORK / "train")
    config = train_config(root)
    net = api.get_pmnet_dev(device=dev, weight_path=ckpt)
    np.random.seed(TRAIN_SEED)  # the centre-noise draws
    trainer = Trainer(config, pmnet=net, device=dev)
    voxelize_cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k6["trainer_fit"] = voxelize_cuda.LAUNCHES["voxelize_pallas"]
    timings = trainer.train_dataset.timings + trainer.val_dataset.timings
    once_per_pocket("trainer fit (per item fetched)", k6["trainer_fit"], len(timings))
    records = [json.loads(x) for x in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {k: [r[k] for r in records if k in r] for k in ("train/loss", "valid/loss")}
    check.true("trainer losses", len(losses["train/loss"]) == 6 and len(losses["valid/loss"]) == 2
               and bool(np.isfinite(losses["train/loss"] + losses["valid/loss"]).all()),
               f"losses {losses}")
    for name in ("best.npz", "last.npz", "resume.ckpt"):
        check.true(f"trainer {name}", (trainer.save_dir / name).exists(), "missing")
    out = dict(
        iterations=6, wall_s=wall, s_per_iteration=wall / 6, items_fetched=len(timings),
        step_s=statistics.median(r["train/time"] for r in records if "train/time" in r),
        item_split_s={k: statistics.median(t[k] for t in timings) for k in timings[0]},
        peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30, losses=losses)

    # last.npz reloads and predicts the same (before any further step)
    items, k6["trainer_check_items"] = k6_count(
        lambda: [trainer.train_dataset[i] for i in range(2)])
    once_per_pocket("trainer items", k6["trainer_check_items"], 2)
    out["hotspots"] = [int(i.hotspot_valid.sum()) for i in items]
    model = copy.deepcopy(trainer.model)
    model.load_state_dict(load_checkpoint(trainer.save_dir / "last.npz", model))
    with torch.no_grad():
        got = model(*items[0].model_args(dev)).cpu().numpy()
        want = trainer.model(*items[0].model_args(dev)).cpu().numpy()
    out["last_npz_max_abs_err"] = check.close("last.npz reloaded predicts the same", got, want)

    # one step on the card against the CPU, same items and parameters
    cpu = torch.device("cpu")
    card_twin, cpu_twin = copy.deepcopy(trainer.model), copy.deepcopy(trainer.model).to(cpu)
    cpu_items = [dataclasses.replace(i, multi_scale_features=[f.cpu() for f in
                                                              i.multi_scale_features])
                 for i in items]
    ref_twin = copy.deepcopy(cpu_twin).double()
    ref_params = dict(ref_twin.named_parameters())
    ref_loss = torch.stack([ref_twin.loss(*as_float64(i.loss_args(cpu)))
                            for i in cpu_items]).mean()
    ref = dict(zip(ref_params, torch.autograd.grad(ref_loss, list(ref_params.values()),
                                                   allow_unused=True)))
    steps = []
    for twin, its, d in ((card_twin, items, dev), (cpu_twin, cpu_items, cpu)):
        loss, grads = trainer._loss_and_grads(its, twin, d)
        params = dict(twin.named_parameters())
        updates, _ = trainer.optimizer.update(grads, trainer.optimizer.init(params))
        apply_updates(params, updates)
        steps.append((float(loss), grads, twin))
    out["step_card_vs_cpu"] = step_card_vs_cpu(check, "trainer step", *steps, ref)

    # resume from resume.ckpt (iteration 6), then one step, against the run
    # that went on uninterrupted
    resumed = Trainer(config, pmnet=net, device=dev)
    check.true("restore_state", resumed.restore_state(trainer.save_dir / "resume.ckpt")[0] == 6,
               "not iteration 6")
    trainer._train_step(items)
    resumed._train_step(items)
    out["resume_max_param_diff"] = max_param_diff(trainer.model, resumed.model)
    out["item_timings_s"] = timings
    check.true("resume then one step", out["resume_max_param_diff"] <= STEP_PARAM_TOL,
               f"parameters {out['resume_max_param_diff']} apart")
    resumed.close()

    out["step_busy"] = device_busy(lambda: trainer._train_step(items), top=6)
    trainer.close()
    log(f"  trainer: 6 iterations in {wall:.3f} s ({out['s_per_iteration']:.3f} s per "
        f"iteration, median step {out['step_s'] * 1e3:.1f} ms host), {len(timings)} items "
        f"fetched (K6 once each); item split (s, median) {out['item_split_s']}; peak "
        f"{out['peak_memory_gib']:.2f} GiB; losses {losses}")
    log(f"    step on the card (torch.profiler, 2 items): {out['step_busy']}; card vs CPU "
        f"{out['step_card_vs_cpu']}, resume {out['resume_max_param_diff']:.3g}, last.npz "
        f"{out['last_npz_max_abs_err']:.3g}")
    return out


def phase_detector(dev, check: Checks) -> dict:
    """The detector's train step at the published architecture (33 x 64^3,
    embed 96, depths 2/6/2/2; the synthesized checkpoint) on
    make_dummy_batch(2, 64, 16), 5 steps; one step at the micro widths on
    the card against the CPU."""
    from pharmaconet_tpu_torch.module import precision_scope
    from pharmaconet_tpu_torch.network.convert import synthesize_torch_state_dict
    from pharmaconet_tpu_torch.network.model import build_model
    from pharmaconet_tpu_torch.training import train_step

    model = build_model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synthesize_torch_state_dict(CKPT_SEED, CKPT_SCALE).items()})
    model.to(dev)
    step = train_step.make_train_step(model, train_step.make_optimizer())
    batch = train_step.make_dummy_batch(DETECTOR_BATCH, 64, DETECTOR_TOKENS, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(DETECTOR_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check.true("detector losses", bool(np.isfinite(losses).all()), f"losses {losses}")
    out = dict(losses=losses, step_ms=times, ms_per_step=statistics.median(times[1:]),
               peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               step_busy=device_busy(lambda: step(batch), top=8))
    del model, step
    torch.cuda.empty_cache()

    torch.manual_seed(0)
    cpu_model = train_step.all_tensors_trainable(build_model(image_size=8, **MICRO))
    card_model = copy.deepcopy(cpu_model).to(dev)
    small = train_step.make_dummy_batch(2, 8, 4)
    optimizer = train_step.make_optimizer()
    ref_model = copy.deepcopy(cpu_model).double()
    ref_params = dict(ref_model.named_parameters())
    ref_loss = train_step.detector_loss(ref_model, {k: torch.from_numpy(v).double()
                                                    if v.dtype.kind == "f" else torch.from_numpy(v)
                                                    for k, v in small.items()})
    ref = dict(zip(ref_params, torch.autograd.grad(ref_loss, list(ref_params.values()),
                                                   allow_unused=True)))
    steps = []
    for model, d in ((card_model, dev), (cpu_model, torch.device("cpu"))):
        params = dict(model.named_parameters())
        with precision_scope("float32", d):
            loss = train_step.detector_loss(model, {k: torch.from_numpy(v).to(d)
                                                    for k, v in small.items()})
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                         allow_unused=True)))
        updates, _ = optimizer.update(grads, optimizer.init(params))
        train_step.apply_updates(params, updates)
        steps.append((float(loss.detach()), grads, model))
    out["micro_card_vs_cpu"] = step_card_vs_cpu(check, "detector step (micro)", *steps, ref)
    log(f"  detector step at full width: {out['ms_per_step']:.1f} ms per step (median of steps "
        f"2-{DETECTOR_STEPS}; all {[round(t, 1) for t in times]}), peak "
        f"{out['peak_memory_gib']:.2f} GiB, losses {[round(x, 4) for x in losses]}; micro card "
        f"vs CPU {out['micro_card_vs_cpu']}")
    log(f"    one step on the card (torch.profiler): {out['step_busy']}")
    return out


def phase_train(dev, kernels: dict, card: str) -> dict:
    """Serving at scale, the affinity-head trainer and the detector step on
    the full-width trunk of phase 7; K6 counted on every path."""
    from pharmaconet_tpu_torch.network.convert import (
        random_distributions,
        save_torch_checkpoint,
        synthesize_torch_state_dict,
    )
    from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

    out: dict = {"card": card}
    check = Checks("phase 11")
    k6: dict[str, int] = {}
    ckpt = WORK / "train_ckpt.tar"
    save_torch_checkpoint(ckpt, synthesize_torch_state_dict(CKPT_SEED, CKPT_SCALE),
                          random_distributions(), config={"synthesized": [CKPT_SEED, CKPT_SCALE]})
    pockets = []
    for seed in range(3):  # phase 10's pockets
        pdb = WORK / f"serve_pocket{seed}.pdb"
        pockets.append((pdb, write_synthetic_pocket(pdb, seed=seed)["center"]))
    t0 = time.perf_counter()
    out["serve"] = phase_serve(dev, ckpt, pockets, check, k6)
    out["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["trainer"] = phase_trainer(dev, ckpt, check, k6)
    out["trainer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["detector"] = phase_detector(dev, check)
    out["detector_s"] = time.perf_counter() - t0
    out["k6_launches"] = k6
    out["comparisons"] = check.seen
    kernels["voxelize_pallas"]["launches_train"] = sum(k6.values())
    kernels["voxelize_pallas"]["launches_train_paths"] = k6
    log(f"  phase parts (host s): serve {out['serve_s']:.1f}, trainer {out['trainer_s']:.1f}, "
        f"detector {out['detector_s']:.1f}; comparisons: {check.seen}")
    check.raise_misses()
    return out


# --------------------------------------------------------------------------
# Phase 12: sharded screening and sharded modeling
# --------------------------------------------------------------------------
SHARD_LIVE = {  # engine mapping -> (ShardedScreener flags, the kernel each share launches)
    "K1": (dict(), "score_tiles_fused_rows"),
    "K5": (dict(native_pack=False), "gaussian_phase"),
    "reference": (dict(engine="reference"), None),
}
SHARD_POCKETS = 3  # modeler pockets (phase 10's seeds 0-2), segmenter devices
SHARD_HETS = [("LIG", "A", 901, (0.0, 0.0, 0.0)), ("MOV", "B", 1, (0.0, 1.4, 1.2))]


def rates_in_turns(fns: dict, work: int, rounds: int = 3) -> dict:
    """`work` per median host second of each of `fns` (each call ending in
    a synchronize), the functions called in turns, forward then backward
    (2 * rounds calls each), so that no one of them always runs first."""
    times: dict[str, list] = {k: [] for k in fns}
    order = list(fns)
    for r in range(2 * rounds):
        for k in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: work / statistics.median(v) for k, v in times.items()}


def screen_counts(fn):
    """(fn's result, the screening kernels' launch counts): reset just
    before, read just after."""
    from pharmaconet_tpu_torch.ops import screen_cuda

    screen_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in screen_cuda.LAUNCHES.items() if v}


def shard_screening(pm, packed, names, ref, dev, check: Checks, launches: dict) -> dict:
    """ShardedScreener on [cuda:0] and [cuda:0] * 2 against BatchScreener:
    the headline batch in each live mode, then phase 6's v3 and v2 stores
    through score_stored_group; ligands/s of each."""
    from pharmaconet_tpu_torch.parallel.screening import ShardedScreener
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore

    out: dict = {}
    head, head_names = packed[:N_BATCH], names[:N_BATCH]
    for mode, (flags, kernel) in SHARD_LIVE.items():
        single = BatchScreener(pm, device=dev, **flags)
        want = single.score_packed(head)
        check.close(f"live {mode} BatchScreener vs reference engine", want,
                    np.asarray([ref[k] for k in head_names]))
        res, timed = {}, {"single": lambda single=single: single.score_packed(head)}
        for n in (1, 2):
            sharded = ShardedScreener(pm, mesh=[dev] * n, **flags)
            timed[f"{n}_shares"] = lambda sharded=sharded: sharded.score_packed(head)
            got, counts = screen_counts(lambda: sharded.score_packed(head))
            res[f"{n}_launches"] = counts
            res[f"{n}_max_abs_err"] = check.close(f"live {mode} on {n} shares vs BatchScreener",
                                                  got, want)
            check.true(f"live {mode} on {n} shares zero scores",
                       [g == 0 for g in got] == [w == 0 for w in want], "zero-score sets differ")
            check.true(f"live {mode} on {n} shares launches",
                       counts == ({kernel: n} if kernel else {}), f"launched {counts}")
            if kernel:
                launches[kernel] = launches.get(kernel, 0) + counts.get(kernel, 0)
        if mode == "K1":
            res["ligands_per_s"] = rates_in_turns(timed, N_BATCH)
        out[f"live_{mode}"] = res

    single = BatchScreener(pm, device=dev)
    for version, kernel in (("v3", "score_tiles_v3"), ("v2", "score_tiles_fused_dt")):
        store = TiledStore(WORK / f"tiles_{version}", pm)
        sbs = [store.load(bi) for bi in range(store.n_batches)]
        n_lig = sum(sb.batch_len for sb in sbs)
        want = [single.score_stored(sb) for sb in sbs]
        res = {"batches": len(sbs)}
        timed = {"single": lambda: [single.score_stored(sb) for sb in sbs]}
        for n in (1, 2):
            sharded = ShardedScreener(pm, mesh=[dev] * n)

            def grouped(sharded=sharded, n=n):
                return [s for g in range(0, len(sbs), n)
                        for s in sharded.score_stored_group(sbs[g:g + n])]

            timed[f"{n}_shares"] = grouped
            got, counts = screen_counts(grouped)
            res[f"{n}_launches"] = counts
            res[f"{n}_max_abs_err"] = check.close(
                f"stored {version} groups of {n} vs score_stored", np.concatenate(got),
                np.concatenate(want))
            check.true(f"stored {version} groups of {n} launches",
                       counts == {kernel: len(sbs)}, f"launched {counts}")
            launches[kernel] = launches.get(kernel, 0) + counts.get(kernel, 0)
        res["ligands_per_s"] = rates_in_turns(timed, n_lig)
        out[f"stored_{version}"] = res
    return out


def shard_screening_cli(dev, check: Checks, launches: dict) -> dict:
    """The screening CLI's mesh branch (its mesh function patched to
    [cuda:0] * 2) on phase 4's --library and phase 6's v3 --library_tiles:
    each CSV against the single-card CLI's CSV of those phases."""
    from pharmaconet_tpu_torch.cli import screening as cli

    out: dict = {}
    real = cli._screening_mesh
    cli._screening_mesh = lambda args: [dev] * 2
    try:
        for route, src, single_csv, kernel in (
                ("library", ["--library", str(WORK / "lib.npz"), "--batch_size", str(N_BATCH)],
                 "lib.csv", "score_tiles_fused_rows"),
                ("library_tiles", ["--library_tiles", str(WORK / "tiles_v3")], "v3.csv",
                 "score_tiles_v3")):
            csv = WORK / f"shard_{route}.csv"
            args = cli.build_parser().parse_args(["-p", str(WORK / "model.pm"), *src,
                                                  "-o", str(csv), "--device", str(dev)])
            (rc, wall), counts = screen_counts(lambda: host_s(lambda: cli.main(args), reps=1))
            check.true(f"CLI mesh {route} exit code", rc == 0, f"exited {rc}")
            got, want = read_csv(csv), read_csv(WORK / single_csv)
            check.true(f"CLI mesh {route} ligands", got.keys() == want.keys(),
                       f"{len(got)} against {len(want)} ligands")
            keys = sorted(want)
            err = check.close(f"CLI mesh {route} vs single-card CSV",
                              np.asarray([got.get(k, np.nan) for k in keys]),
                              np.asarray([want[k] for k in keys]))
            check.true(f"CLI mesh {route} launches", counts.get(kernel, 0) >= 4,
                       f"launched {counts}")
            launches[kernel] = launches.get(kernel, 0) + counts.get(kernel, 0)
            out[route] = dict(wall_s=wall, ligands=len(got), ligands_per_s=len(got) / wall,
                              launches=counts, max_abs_err=err)
    finally:
        cli._screening_mesh = real
    return out


def shard_modeling(dev, check: Checks, k6: dict) -> dict:
    """ShardedModeler on [cuda:0] * 3 over phase 10's three pockets against
    PharmacoNet per pocket, and ShardedSegmenter on [cuda:0] * 3 on phase
    10's pocket 0 (get_pmnet_dev) against create_density_maps, both with
    phase 7's checkpoint; then the modeling CLI with --shard --all and with
    --profile on the pocket with two HET ligands."""
    from pharmaconet_tpu_torch import api
    from pharmaconet_tpu_torch.cli import modeling as cli
    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.parallel.modeling import ShardedModeler, ShardedSegmenter
    from pharmaconet_tpu_torch.synthetic import append_het_ligands, write_synthetic_pocket

    out: dict = {}
    ckpt = WORK / "ckpt.tar"  # phase 7's
    jobs = []
    for seed in range(SHARD_POCKETS):
        pdb = WORK / f"shard_pocket{seed}.pdb"
        jobs.append((pdb, None, write_synthetic_pocket(pdb, seed=seed)["center"]))
    mesh = [dev] * SHARD_POCKETS

    net = PharmacoNet(weight_path=ckpt, device=dev, verbose=False)
    datas = [net.parse(p, center=c) for p, _, c in jobs]
    (want, k6["serial_pockets"]) = k6_count(lambda: [net.create_density_maps(d) for d in datas])
    modeler = ShardedModeler(net, mesh=mesh)
    got, k6["sharded_modeler"] = k6_count(lambda: modeler.create_density_maps_batch(datas))
    once_per_pocket("ShardedModeler", k6["sharded_modeler"], SHARD_POCKETS)
    for i, (g, w) in enumerate(zip(got, want)):
        check.true(f"ShardedModeler pocket {i} hotspots",
                   [(h["nci_type"], h["hotspot_position"], h["hotspot_score"]) for h in g] ==
                   [(h["nci_type"], h["hotspot_position"], h["hotspot_score"]) for h in w],
                   f"{len(g)} against {len(w)} hotspots")
        if len(g) == len(w):
            check.close(f"ShardedModeler pocket {i} maps", [h["point_map"] for h in g],
                        [h["point_map"] for h in w], rtol=0.0, atol=0.0)
    models, _ = k6_count(lambda: modeler.run_batch(jobs))
    for i, (m, job) in enumerate(zip(models, jobs)):
        single = net.run(job[0], center=job[2])
        check.true(f"ShardedModeler.run_batch pocket {i} .pm",
                   pickle.dumps(m.__getstate__()) == pickle.dumps(single.__getstate__()),
                   "the .pm differs from PharmacoNet.run's")
    out["modeler"] = dict(pockets=SHARD_POCKETS, hotspots=[len(g) for g in got],
                          pockets_per_s=rates_in_turns({
                              "run_loop": lambda: [net.run(p, center=c) for p, _, c in jobs],
                              "run_batch": lambda: modeler.run_batch(jobs)}, SHARD_POCKETS, 2))

    dev_net = api.get_pmnet_dev(device=dev, weight_path=ckpt)
    pdb, _, center = jobs[0]
    data = dev_net.parse(pdb, center=center)
    keep = int(dev_net.run_trunk(data)["keep"].sum())
    step = SHARD_POCKETS * dev_net.segmentation_chunk
    segmenter = ShardedSegmenter(dev_net, mesh=mesh)
    want, _ = k6_count(lambda: dev_net.create_density_maps(data))
    got, k6["sharded_segmenter"] = k6_count(lambda: segmenter.create_density_maps(data))
    once_per_pocket("ShardedSegmenter", k6["sharded_segmenter"])
    check.true("ShardedSegmenter hotspots",
               [(h["nci_type"], h["hotspot_position"], h["hotspot_score"]) for h in got] ==
               [(h["nci_type"], h["hotspot_position"], h["hotspot_score"]) for h in want],
               f"{len(got)} against {len(want)} hotspots")
    if len(got) == len(want):
        check.close("ShardedSegmenter maps", [h["point_map"] for h in got],
                    [h["point_map"] for h in want], rtol=0.0, atol=0.0)
    per_s = rates_in_turns({"create_density_maps": lambda: dev_net.create_density_maps(data),
                            "segmenter": lambda: segmenter.create_density_maps(data)}, 1, 2)
    padded = -(-keep // step) * step
    out["segmenter"] = dict(kept_tokens=keep, padded_tokens=padded,
                            chunks_per_share=padded // step, hotspots=len(got),
                            ms={k: 1e3 / v for k, v in per_s.items()})

    het = WORK / "shard_complex.pdb"
    het.write_text(pdb.read_text())
    c = np.asarray(center)
    append_het_ligands(het, [(h, ch, r, tuple(c + d)) for h, ch, r, d in SHARD_HETS])
    real = cli._modeling_mesh
    cli._modeling_mesh = lambda args: mesh
    runs = {}
    try:
        for label, extra in (("all", []), ("shard_all", ["--shard"]),
                             ("profile_all", ["--profile", str(WORK / "trace")])):
            args = cli.build_parser().parse_args([
                "-p", str(het), "--all", "--prefix", "cx", "--out_dir",
                str(WORK / f"shard_cli_{label}"), "--weight_path", str(ckpt), "--device",
                str(dev), *extra])
            (rc, wall), k6[f"modeling_cli_{label}"] = k6_count(
                lambda: host_s(lambda: cli.main(args), reps=1))
            once_per_pocket(f"modeling CLI {label}", k6[f"modeling_cli_{label}"], len(SHARD_HETS))
            check.true(f"modeling CLI {label} exit code", rc == 0, f"exited {rc}")
            runs[label] = ({p.name: p.read_bytes() for p in
                            sorted((WORK / f"shard_cli_{label}").glob("*_model.pm"))}, wall)
    finally:
        cli._modeling_mesh = real
    plain = runs["all"][0]
    check.true("modeling CLI sites", len(plain) == len(SHARD_HETS), f"wrote {sorted(plain)}")
    for label in ("shard_all", "profile_all"):
        check.true(f"modeling CLI {label} .pm", runs[label][0] == plain,
                   "the .pm files differ from the run without the flag")
    traces = sorted((WORK / "trace").glob("*.pt.trace.json"))  # one per site modeled
    kernel_events = [sum(e.get("cat") == "kernel" for e in json.loads(t.read_text())["traceEvents"])
                     for t in traces]
    check.true("modeling CLI --profile traces",
               len(traces) == len(SHARD_HETS) and min(kernel_events, default=0) > 0,
               f"{len(traces)} trace files, CUDA kernel events {kernel_events}")
    out["modeling_cli"] = {label: dict(wall_s=wall, sites=len(pms))
                           for label, (pms, wall) in runs.items()}
    out["modeling_cli"]["trace_kernel_events"] = kernel_events
    return out


def phase_shard(pm, packed, names, ref, dev, kernels: dict, card: str) -> dict:
    """Sharded screening and sharded modeling on meshes that name cuda:0
    one to three times; every launch count read just after its path."""
    out: dict = {"card": card}
    check = Checks("phase 12")
    launches: dict[str, int] = {}
    k6: dict[str, int] = {}
    t0 = time.perf_counter()
    out["screening"] = shard_screening(pm, packed, names, ref, dev, check, launches)
    out["screening_cli"] = shard_screening_cli(dev, check, launches)
    out["screening_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["modeling"] = shard_modeling(dev, check, k6)
    out["modeling_s"] = time.perf_counter() - t0
    out["screening_launches"] = launches
    out["k6_launches"] = k6
    out["comparisons"] = check.seen
    for name, n in launches.items():
        kernels[name]["launches_shard"] = n
    kernels["voxelize_pallas"]["launches_shard"] = sum(
        v for k, v in k6.items() if k != "serial_pockets")
    for route in ("live_K1", "stored_v3", "stored_v2"):
        log(f"  {route}, ligands/s on {card} (BatchScreener, ShardedScreener on 1 and 2 "
            f"shares, in turns): {out['screening'][route]['ligands_per_s']}")
    log(f"  screening CLI mesh branch: {out['screening_cli']}")
    log(f"  modeling: {out['modeling']}")
    log(f"  launches: screening {launches}, K6 {k6}; phase parts (host s): screening "
        f"{out['screening_s']:.1f}, modeling {out['modeling_s']:.1f}")
    log(f"  comparisons: {check.seen}")
    check.raise_misses()
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
        log("[10] feature extraction and the docking proxies at full width")
        print(json.dumps({"proxy": phase_proxy(dev, kernels, smi)}), flush=True)
        log("[11] serving at scale and training at full width")
        print(json.dumps({"train": phase_train(dev, kernels, smi)}), flush=True)
        log("[12] sharded screening and sharded modeling on meshes of cuda:0")
        print(json.dumps({"shard": phase_shard(pm, packed, names, ref, dev, kernels, smi)}),
              flush=True)
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
