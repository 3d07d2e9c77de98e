"""Shared parts of the stored-route probes (`probe_leaf_phases`,
`probe_shape_sweep`, `probe_sparse_wire`, `probe_sparse_split`,
`probe_gather_variants`, `probe_scan_share`, `probe_dfs_stats`,
`probe_layout_stats`) and the decoder probes (`probe_seg_bf16`,
`probe_conv_ladder`).

Each probe runs as `python -m pharmaconet_tpu_torch.probes.<probe>` with
its sizes as flags (the JAX probes' defaults), --device (default cuda;
cuda without a card raises), --work_dir (a fresh temporary directory by
default; a given one must be empty), --report (default
<work_dir>/report.json), --keep and --reps (calls per timing round). It
writes only under its work directory and to its report, prints the report
as its last line (`{"probe": name, "ok": ..., ...}`), and exits 1 when a
gate misses: scores are held to rtol 2e-5 / atol 1e-4 with equal -1
masks. Times come from `probes/timing.py` (CUDA events; `stream_ms`, the
card's own time per call back to back); on the CPU they are host-clock
times of the plain torch versions and name no device metric.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ops import launch_log, screen_cuda
from . import scale
from .scale import DemoError
from .timing import REPS, time_rounds

RTOL, ATOL = scale.RTOL, scale.ATOL


class ProbeError(DemoError):
    """A probe's gate missed."""


def log(msg: str) -> None:
    print(f"[probe] {msg}", flush=True)


def parser(description: str, n: int, n_help: str):
    p = scale.common_parser(description, n, n_help)
    p.add_argument("--reps", type=int, default=REPS,
                   help="calls per timing round (3 rounds, probes/timing.py)")
    return p


def run(name: str, args, body) -> int:
    """scale.run_demo with the report keyed "probe"; the kernels' launch
    counts of this process (timing and gate launches included) go into
    the report as `launches`."""
    def wrapped(args, work, report):
        body(args, work, report)
        report["launches"] = {k: v for k, v in launch_log.counts().items() if v}
    return scale.run_demo(name, args, wrapped, kind="probe")


def device_of(args) -> torch.device:
    from ..device import resolve_device

    return resolve_device(args.device)


def pin_full_f32() -> None:
    """Full-f32 products and convolutions: the leaf chain refuses TF32
    (leaf_tree._require_f32_matmul), and no stage takes torch's defaults."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def times_of(dev: torch.device, fns: dict, reps: int) -> dict[str, dict]:
    """{name: timing dict} over time_rounds; `per_batch_ms` is the card's
    `stream_ms` there, the host clock's median on the CPU."""
    return {k: dict(t.as_dict(), per_batch_ms=t.per_batch)
            for k, t in time_rounds(dev, fns, reps).items()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def headline_inputs(n: int, clusters: int = 20, conformers: int = 4):
    """(model, PackedModel, ligands, names): bench.py's synthetic model
    (seed 0) and ligands (seed 1) from `synthetic.py`, the headline batch
    at the defaults."""
    from ..scoring.batch_screen import PackedModel
    from ..synthetic import make_synthetic_ligands, make_synthetic_model

    model = make_synthetic_model(num_clusters=clusters, seed=0)
    ligands = make_synthetic_ligands(n, num_conformers=conformers, seed=1)
    return model, PackedModel.from_model(model), ligands, [f"l{i}" for i in range(n)]


def write_store(path: Path, pm, ligands, names, dev: torch.device, batch_size: int,
                layout: str = "buckets"):
    """A v3 store written by `write_v3_store` with the leaves baked on
    `dev` (the prepack CLI's defaults: the bucketed layout, the sparse
    wire); returns the TiledStore."""
    from ..scoring.tiled_store import TiledStore, write_v3_store

    write_v3_store(path, pm, ligands, names, batch_size=batch_size, threads=8, verbose=False,
                   leaf_layout=layout, device=str(dev))
    return TiledStore(path, pm)


@dataclass
class Operands:
    """One stored v3 batch's operand tree on the device, copied the way
    `BatchScreener._dispatch_stored_v3` copies it (`_to_device`, per
    array). The single-window layout is one bucket whose ligand index is
    the batch order."""

    k2: tuple  # dt, gid, tab, aux
    depth: int
    mn_cap: int
    buckets: tuple  # dense 6-tuples or sparse 7-tuples (leaf_tree.leaf2_scores_multi)
    out_ends: torch.Tensor
    nb: int
    single: bool

    def rows(self) -> torch.Tensor:
        """K2 (`score_tiles_v3_rows`; its plain version on the CPU)."""
        return screen_cuda.score_tiles_v3_rows(*self.k2, depth=self.depth, mn_cap=self.mn_cap)

    def chain(self, rows: torch.Tensor | None = None):
        """K2 and the leaf chain, as the stored route dispatches them:
        ([nb] scores, outlier pair rows)."""
        from ..scoring.leaf_tree import leaf2_scores_device, leaf2_scores_multi

        rows = self.rows() if rows is None else rows
        if self.single:
            ends2, ps, pc, pw, conf, _ = self.buckets[0]
            return leaf2_scores_device(rows, ends2, ps, pc, pw, conf, self.out_ends)
        return leaf2_scores_multi(rows, self.out_ends, self.buckets, nb=self.nb)


def operand_arrays(sb) -> list[np.ndarray]:
    """The host arrays of a leaf-baked stored batch that the device reads:
    K2's four, the outlier ends, then every bucket's (or the single
    window's) arrays."""
    arrays = [sb.dt, sb.gid, sb.tab, sb.aux, sb.leaf2_out_ends]
    if sb.leaf_buckets is not None:
        for b in sb.leaf_buckets:
            arrays.extend(b)
    else:
        arrays.extend((sb.leaf2_ends, sb.leaf2_ps, sb.leaf2_pc, sb.leaf2_pw, sb.leaf_conf))
    return arrays


def operands(screener, sb) -> Operands:
    """The batch's operand tree copied to the screener's device by its
    `_to_device`, laid out as operand_arrays(sb)."""
    if sb.leaf_buckets is None and sb.leaf2_ps is None:
        raise ProbeError("the stored batch has no baked leaves")
    tensors = [screener._to_device(a) for a in operand_arrays(sb)]
    k2, out_ends, rest = tuple(tensors[:4]), tensors[4], tensors[5:]
    if sb.leaf_buckets is None:
        lig = torch.arange(rest[3].shape[0], device=rest[3].device)  # [B] batch order
        return Operands(k2, sb.depth, sb.mn_cap, (tuple(rest) + (lig,),), out_ends,
                        len(sb.leaf_conf), True)
    arity = len(sb.leaf_buckets[0])
    buckets = tuple(tuple(rest[k * arity:(k + 1) * arity]) for k in range(len(sb.leaf_buckets)))
    return Operands(k2, sb.depth, sb.mn_cap, buckets, out_ends, sb.leaf_nb, False)


def bucket_specs(sb) -> list[tuple[int, int, int]]:
    """(Bk, Lk, Wk) of each leaf bucket, or of the single window."""
    if sb.leaf_buckets is None:
        return [(sb.leaf2_pw.shape[0], sb.leaf2_ps.shape[1], sb.leaf2_pw.shape[1])]
    # the sparse wire's 7th array is a [Lk, 0] placeholder; the dense
    # wire's planes are [Bk, Lk, Wk/8]
    return [(b[3].shape[0], b[6].shape[0] if len(b) == 7 else b[1].shape[1], b[3].shape[1])
            for b in sb.leaf_buckets]


def store_stats(sb) -> dict:
    """A stored v3 batch's shape: tiles, conformer slots, K2's table (g_cap,
    r_pad, mn_cap, depth) and shared bytes per block, the leaf layout's
    (Bk, Lk, Wk) buckets, its gathered window slots and outlier ligands."""
    t, c = sb.dt.shape[0], sb.dt.shape[1]
    g_cap, r_pad = sb.tab.shape[1], sb.tab.shape[2]
    specs = bucket_specs(sb)
    return dict(tiles=t, conformer_slots=c, g_cap=g_cap, r_pad=r_pad, mn_cap=sb.mn_cap,
                depth=sb.depth,
                shared_bytes=screen_cuda.v3_shared_bytes(min(c, screen_cuda.MAX_CONFORMERS),
                                                         g_cap, r_pad),
                layout="single" if sb.leaf_buckets is None else "buckets",
                buckets=[list(s) for s in specs], slots=sum(bk * wk for bk, _, wk in specs),
                outliers=len(sb.leaf2_out["live"]), batch_len=sb.batch_len)


def batch_scores(screener, sb, result) -> np.ndarray:
    """A stored batch's scores in batch order (the outliers' host DFS
    included) from the device chain's result."""
    return np.asarray(screener.postprocess_stored(sb, result), np.float64)


def gate_scores(label: str, got, want) -> dict:
    """Scores within rtol/atol of `want` and -1 where `want` is -1
    (raises ProbeError otherwise); returns the largest difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ProbeError(f"{label}: {got.shape} scores against {want.shape}")
    diff = float(np.abs(got - want).max(initial=0.0))
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    bad = int((np.abs(got - want) > ATOL + RTOL * np.abs(want)).sum())
    if mism or bad:
        raise ProbeError(f"{label}: {bad} scores outside rtol {RTOL} / atol {ATOL}, {mism} -1 "
                         f"mismatches (largest difference {diff:.3g})")
    return dict(max_abs_diff=diff, bit_equal=bool(np.array_equal(got, want)))


def gate_rows(label: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """gate_scores on tensors, computed where they lie (kernel rows
    against their plain versions, the conv ladder's rungs)."""
    if got.shape != want.shape:
        raise ProbeError(f"{label}: {tuple(got.shape)} against {tuple(want.shape)}")
    diff = (got - want).abs()
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    bad = int((diff > ATOL + RTOL * want.abs()).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    if mism or bad:
        raise ProbeError(f"{label}: {bad} values outside rtol {RTOL} / atol {ATOL}, {mism} -1 "
                         f"mismatches (largest difference {worst:.3g})")
    return dict(max_abs_diff=worst, bit_equal=bool(torch.equal(got, want)))


def stored_stages(screener, store, bi: int, reps: int = 3) -> dict[str, float]:
    """Host-clock ms of one stored batch's stages (median of `reps`):
    `load` (the store's mmap reads, paged in), `copy` (the operand tree to
    the device, synchronised: the dispatch's host prep), `chain` (K2 and
    the leaf chain, synchronised) and `tail` (scores back and the
    outliers' host DFS)."""
    from ..scoring.tiled_store import _page_in

    dev = screener.device
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sb = store.load(bi)
        _page_in(sb)
        t1 = time.perf_counter()
        ops = operands(screener, sb)
        sync(dev)
        t2 = time.perf_counter()
        result = ops.chain()
        sync(dev)
        t3 = time.perf_counter()
        screener.postprocess_stored(sb, result)
        t4 = time.perf_counter()
        runs.append((t1 - t0, t2 - t1, t3 - t2, t4 - t3))
    return {k: statistics.median(r[i] for r in runs) * 1e3
            for i, k in enumerate(("load", "copy", "chain", "tail"))}


def reference_scores(pm, ligands, dev: torch.device) -> np.ndarray:
    """The plain-torch reference engine's scores (score_blocks_device + the
    host DFS) on `dev`: what chip_smoke's phases hold the routes to."""
    from ..scoring.batch_screen import BatchScreener

    return np.asarray(BatchScreener(pm, engine="reference", device=dev).score_packed(ligands),
                      np.float64)
