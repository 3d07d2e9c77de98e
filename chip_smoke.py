"""Smoke run of the PyTorch/CUDA port on one GPU (exits non-zero on any fault).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device  — needs torch.cuda; prints the card's name and power limit
  2. build   — compiles the CUDA kernels (nvcc, sm_90a) and the native host
               libraries (g++) from the sources in this checkout, in parallel
  3. kernels — at the headline batch (20-cluster model seed 0, 2048 ligands
               x 4 conformers seed 1) holds each hand kernel (K1, K4, K5)
               against its plain torch version on the card and times both
  4. paths   — the --library CLI route on 8 x 2048 ligands (K1), and the
               native_pack=False (K4) and fused=False (K5) screener paths;
               each with the launch counts reset just before and read just
               after; every score against the plain-torch reference engine
  5. -d      — the CLI on ~200 random .sdf/.mol2 files, every score against
               the exact host GraphMatcher
Then prints the {"kernels": [...]} line, the nvidia-smi name/power line, and
last {"ok": true, "device": {...}}.
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

import torch

RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
F32_OPS_PER_S = 67e12  # H100 SXM published f32 rate outside the tensor cores
WORK = Path(__file__).resolve().parent / ".smoke_work"
N_BATCH, N_BATCHES, N_FILES = 2048, 8, 200


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
    from pharmaconet_tpu_torch.ops import screen_cuda

    t0 = time.perf_counter()
    jobs = [screen_cuda.load_library, native.get_pack_tiled, native.get_block_packer,
            native.get_prep_args, native.get_match_dfs]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(j) for j in jobs]:
            f.result()
    return time.perf_counter() - t0


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """Max abs error and -1 mismatches; raises outside the tolerance."""
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    err = float((got - want).abs().max())
    if mism or not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, -1 mismatches {mism})")
    return err, mism


def ops_per_row(c: int, depth1: int, depth2: int, fused: bool) -> int:
    """f32 operations per row as the kernels do them (exp and sqrt as one):
    distance 9 per conformer, 9 per (model pair, conformer) in the Gaussian
    phase, and for the fused kernels one add per scan step and stacked
    value plus 3 per conformer in the block and pair tails."""
    ops = 9 * c + 9 * 8 * c
    if fused:
        ops += 2 * c * (depth1 + depth2) + 3 * c
    return ops


def kernel_entry(name, source_line, fn, plain, inputs, out, rows, c, depths, fused, tiles):
    err, mism = compare(name, out, plain())
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + out.numel() * 4
    ops = rows * ops_per_row(c, *depths, fused)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    entry = dict(
        name=name, route="cuda", source="pharmaconet_tpu_torch/csrc/screen_fused.cu",
        replaces=f"pharmaconet_tpu/ops/screen_pallas.py:{source_line}",
        launches=0, max_abs_err=err, ms=time_ms(fn, 30), plain_ms=time_ms(plain, 5),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, minus1_mismatches=mism, tiles=tiles, bytes=nbytes, ops=ops,
    )
    log(f"  {name}: T={tiles} max_abs_err={err:.3g} -1 mismatches={mism} "
        f"ms={entry['ms']:.4f} plain_ms={entry['plain_ms']:.3f} bound_ms={entry['bound_ms']:.4f}")
    return entry


def phase_kernels(pm, ligands, dev) -> dict:
    from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, build_batch
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
    out["score_tiles_fused_rows"] = kernel_entry(
        "score_tiles_fused_rows", 463, k1,
        lambda: screen_ref.score_tiles_fused_rows(*k1_in, *d),
        k1_in, k1(), tiles * 1024, c, d, True, tiles)

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
    out["score_blocks_fused"] = kernel_entry(
        "score_blocks_fused", 516, k4,
        lambda: screen_ref.score_blocks_fused(*g_in, *rows_in, *d),
        g_in + rows_in, k4(), tiles * 1024, c, d, True, tiles)
    k5 = lambda: screen_cuda.gaussian_phase(*g_in)  # noqa: E731
    out["gaussian_phase"] = kernel_entry(
        "gaussian_phase", 114, k5, lambda: screen_ref.gaussian_phase(*g_in),
        g_in, k5(), tiles * 1024, c, (0, 0), False, tiles)
    torch.cuda.synchronize()
    return out


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


def phase_paths(model, pm, dev, kernels: dict, card: str) -> None:
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
        phase_paths(model, pm, dev, kernels, smi)
        log("[5] -d route")
        phase_dir(model, dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
