"""The port's on-chip regression battery: every precision-sensitive path
on the card in one command (the counterpart of the repo's
`probes/chip_ci.py`, with its seven checks and gates).

    python -m pharmaconet_tpu_torch.probes.chip_ci [--fast] [--device cuda]

  C1 kernel_vs_matcher    64 fragment SMILES embedded (torch backend) and
                          screened through K1, each score against the exact
                          host GraphMatcher (atol 1e-4 + rtol 2e-5)
  C2 leaf_store_vs_dfs    a v3 store of 256 synthetic ligands in batches of
                          128: the baked-leaf path (K2 + the torch leaf
                          chain) against the host DFS on the same store
                          (rtol 2e-5, atol 1e-4)
  C3 leaf_einsum_f32      K2's rows of the store's first batch through
                          leaf_tree.leaf2_scores_multi on the device against
                          its f64 numpy mirror, within 1e-5 relative: a TF32
                          or bf16 product anywhere in the leaf chain trips it
  C4 embed_determinism    the torch embedder: solo embeds bit-identical to
                          the batched one
  C5 csv_roundtrip        the screening CLI (`cli.screening.main`,
                          --library_tiles) on C2's store in C5_RUNS fresh
                          processes, forked from one fresh interpreter
                          that has imported the port and made no other
                          torch call, so each run's first large call of
                          every torch operation is the first in its
                          process (probe_reproducible.fork_screens):
                          byte-identical CSVs of 256 rows
  C6 seg_precision        the mask decoder at 'tensorfloat32' (the default,
                          run as float32) against float32 on one
                          segmentation chunk (16 random tokens) of a
                          synthetic pocket with a ligand at its centre, at
                          the published width with the JAX package's random
                          parameters: rel < 6e-2 and thresholded-voxel flips
                          <= max(1, on-voxels // 500); one TF32 pass's rel
                          and flips on the same chunk reported beside them,
                          not gated; skipped by --fast
  C7 sparse_density_wire  C6's chunk: the on-device compaction
                          (ops.postprocess.sparse_compact) scattered on the
                          host equals the dense copy bit for bit; skipped by
                          --fast

Each check prints ok or FAIL; the last line is one JSON summary (each
check's seconds, details and kernel launches, counted from 0 at its
start). Exit 1 if any check fails. Files go to a temporary directory,
removed at the end; nothing is written into the repository. `--device
cpu` runs the checks with the kernels' plain versions (TF32 does not
exist there).
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ..device import resolve_device

RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance
C3_REL = 1e-5
C5_RUNS = 4  # fresh processes of C5's screening CLI
C6_REL = 6e-2


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count back to 0."""
    from ..ops import screen_cuda, voxelize_cuda

    screen_cuda.reset_launch_counts()
    voxelize_cuda.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    """Launch counts of every kernel wrapper in this process."""
    from ..ops import screen_cuda, voxelize_cuda

    return {**screen_cuda.LAUNCHES, **voxelize_cuda.LAUNCHES}


def battery_model():
    """The repo battery's screening model (20 clusters, seed 3)."""
    from ..synthetic import make_synthetic_model

    return make_synthetic_model(num_clusters=20, seed=3)


# --------------------------------------------------------------------------
# The checks; each returns its details and raises on a miss
# --------------------------------------------------------------------------
def kernel_vs_matcher(device, model=None) -> dict:
    """C1: 64 fragment SMILES embedded on `device`, screened (K1 on a card),
    against GraphMatcher."""
    from ..chem.fragments import enumerate_fragment_smiles
    from ..scoring.batch_screen import BatchScreener
    from ..scoring.graph_match import GraphMatcher
    from ..scoring.parse_pool import iter_embedded

    model = model or battery_model()
    entries = enumerate_fragment_smiles(64, seed=11)
    ligs = list(iter_embedded(entries, seed=2025, backend="torch", device=device))
    if len(ligs) < 56:
        raise AssertionError(f"embed yielded only {len(ligs)}/64")
    scr = BatchScreener(model, device=device)
    reset_launch_counts()
    got = scr.score_ligands([lig for _, lig in ligs])
    k1 = launch_counts()["score_tiles_fused_rows"]
    worst = 0.0
    for (name, lig), g in zip(ligs, got):
        exact = GraphMatcher(model, lig).run()
        diff = abs(g - exact)
        worst = max(worst, diff)
        if diff > ATOL + RTOL * abs(exact):
            raise AssertionError(f"{name}: kernel {g} vs matcher {exact}")
    if device.type == "cuda" and k1 < 1:
        raise AssertionError("the screener never launched K1")
    return {"n": len(ligs), "engine": scr.engine, "max_abs_diff": worst, "k1_launches": k1}


def embed_determinism(device) -> dict:
    """C4: solo embeds of entries 0, 7 and 15 bit-identical to the batched
    embed of 16 fragment SMILES."""
    from ..chem.fragments import enumerate_fragment_smiles
    from ..scoring.parse_pool import iter_embedded

    entries = enumerate_fragment_smiles(16, seed=23)
    batched = dict(iter_embedded(entries, seed=77, backend="torch", device=device))
    for k in (0, 7, 15):
        name, smi = entries[k]
        solo = dict(iter_embedded([(name, smi)], seed=77 + k, backend="torch", device=device))
        if (name in solo) != (name in batched) or (name in solo and not np.array_equal(
                solo[name].graph.atom_positions, batched[name].graph.atom_positions)):
            raise AssertionError(f"{name}: solo vs batched embed differ")
    return {"n": len(batched)}


def write_battery_store(path: Path, model, device) -> None:
    """C2's v3 store: 256 synthetic ligands (seed 9) in batches of 128,
    leaves baked on `device`."""
    from ..scoring.batch_screen import PackedModel
    from ..scoring.tiled_store import write_v3_store
    from ..synthetic import make_synthetic_ligands

    packed = make_synthetic_ligands(256, seed=9)
    write_v3_store(path, PackedModel.from_model(model), packed,
                   [f"l{i}" for i in range(len(packed))], batch_size=128, verbose=False,
                   device=str(device))


def leaf_store_vs_dfs(store_dir: Path, model, device) -> dict:
    """C2: each batch through the baked leaves (K2 + leaf chain) and,
    leaves stripped, through K2 + the host DFS."""
    from ..scoring.batch_screen import BatchScreener, PackedModel
    from ..scoring.tiled_store import TiledStore

    store = TiledStore(store_dir, PackedModel.from_model(model))
    scr = BatchScreener(model, engine="v3", device=device)
    leaf, dfs, n_out = [], [], 0
    for bi in range(store.n_batches):
        sb = store.load(bi)
        if sb.leaf_buckets is None:
            raise AssertionError("store has no baked leaves")
        n_out += len(sb.leaf2_out["live"])
        leaf.extend(scr.score_stored(sb))
        sb2 = store.load(bi)
        sb2.leaf_buckets = None
        sb2.leaf2_ends = sb2.leaf2_out_ends = sb2.leaf2_out = None
        dfs.extend(scr.score_stored(sb2))
    leaf, dfs = np.asarray(leaf), np.asarray(dfs)
    worst = float(np.abs(leaf - dfs).max())
    np.testing.assert_allclose(leaf, dfs, rtol=RTOL, atol=ATOL)
    return {"n": len(leaf), "outliers": n_out, "max_abs_diff": worst}


def leaf_einsum_f32(store_dir: Path, model, device) -> dict:
    """C3: the leaf chain on the device against its f64 mirror on K2's
    rows of the first batch."""
    from ..ops import screen_cuda
    from ..scoring import leaf_tree as lt
    from ..scoring.batch_screen import PackedModel
    from ..scoring.tiled_store import TiledStore

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    sb = TiledStore(store_dir, PackedModel.from_model(model)).load(0)
    rows_t = screen_cuda.score_tiles_v3_rows(dev(sb.dt), dev(sb.gid), dev(sb.tab), dev(sb.aux),
                                             depth=sb.depth, mn_cap=sb.mn_cap)
    rows = rows_t.cpu().numpy()
    bake = SimpleNamespace(
        buckets=[SimpleNamespace(**dict(zip(
            ("ends2", "plane_score", "plane_cross", "prune_w", "conf", "lig_idx"),
            lt.store_bucket_planes(b)))) for b in sb.leaf_buckets],
        out_ends=np.asarray(sb.leaf2_out_ends))
    host, _ = lt.leaf2_scores_multi_host(rows, bake, sb.leaf_nb)
    buckets = tuple(tuple(dev(a) for a in b) for b in sb.leaf_buckets)
    got, _ = lt.leaf2_scores_multi(rows_t, dev(sb.leaf2_out_ends), buckets, nb=sb.leaf_nb)
    got = got.cpu().numpy()
    rel = float((np.abs(got - host) / np.maximum(np.abs(host), 1e-3)).max())
    if not rel < C3_REL:
        raise AssertionError(f"device leaf products deviate {rel:.2e} rel from the f64 mirror: "
                             "a TF32 or bf16 product crept into the leaf chain")
    return {"max_rel": rel}


def csv_roundtrip(store_dir: Path, model, device, tmp: Path) -> dict:
    """C5: the screening CLI on the store in C5_RUNS fresh processes."""
    from .probe_reproducible import fork_screens, summarize

    model.save(str(tmp / "model.pm"))
    s = summarize(fork_screens(tmp / "model.pm", store_dir, tmp / "c5", C5_RUNS, str(device)))
    if s["distinct_csvs"] != 1:
        d = s["differing_runs"]
        raise AssertionError(f"{s['distinct_csvs']} different CSVs in {C5_RUNS} runs: "
                             f"{len(d)} differ from the most common one, by up to "
                             f"{max(x['rows'] for x in d)} rows and "
                             f"{max(x['max_rel'] for x in d):.3g} relative")
    if s["rows"] != 256:
        raise AssertionError(f"expected 256 rows, got {s['rows']}")
    return {"rows": s["rows"], "runs": C5_RUNS}


def seg_chunk(net, data, seed: int = 0):
    """One segmentation chunk of `net.segmentation_chunk` random valid
    tokens (numpy default_rng(seed)) on the pocket's trunk outputs:
    (trunk outputs, hotspot tokens, their features, valid slots)."""
    out = net.run_trunk(data)
    chunk = net.segmentation_chunk
    n_tok = int(np.asarray(data.token_valid).sum())
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, n_tok, chunk)).to(net.device)
    tokens = torch.from_numpy(np.ascontiguousarray(data.tokens)).to(net.device)
    return out, tokens[idx], out["token_features"][idx], np.ones(chunk, dtype=bool)


def chunk_density(net, chunk, precision: str | None):
    """The chunk's thresholded maps with the mask decoder at `precision`
    (`segment_logits`; None: one TF32 pass, the decoder under
    precision_scope('tensorfloat32')) on the sparse wire: (dense
    [K,D,H,W] on the device, (vals, idxs, counts))."""
    from ..module import precision_scope

    out, hot, feats, valid = chunk
    variant = copy.copy(net)  # shares the network and its tensors
    variant.density_wire = "sparse"
    if precision is None:
        with torch.no_grad(), precision_scope("tensorfloat32", net.device):
            logits = net.model.forward_segmentation(out["pyramid"], hot, feats).float()
    else:
        variant.segmentation_precision = precision
        logits = variant.segment_logits(out, hot, feats)
    return variant.postprocess(out, hot, logits, valid)


def map_deviation(maps: np.ndarray, want: np.ndarray) -> tuple[float, int]:
    """(the largest difference over want's largest value, the voxels above
    0 in one set of thresholded maps and not in the other)."""
    rel = float(np.abs(maps - want).max() / max(float(np.abs(want).max()), 1e-9))
    return rel, int(np.sum((maps > 0) != (want > 0)))


def seg_precision(net, data) -> tuple[dict, dict]:
    """C6: the default 'tensorfloat32' against float32 on one chunk, one
    TF32 pass beside them. Returns (details, the default chunk's state for
    C7)."""
    chunk = seg_chunk(net, data)
    d_default, sparse = chunk_density(net, chunk, "tensorfloat32")
    d_f32_h = chunk_density(net, chunk, "float32")[0].cpu().numpy()
    d_one_h = chunk_density(net, chunk, None)[0].cpu().numpy()
    rel, flips = map_deviation(d_default.cpu().numpy(), d_f32_h)
    one_rel, one_flips = map_deviation(d_one_h, d_f32_h)
    on = int(np.sum(d_f32_h > 0))
    detail = {"max_rel": rel, "voxel_flips": flips, "on_voxels": on,
              "allowed_flips": max(1, on // 500), "one_pass_max_rel": one_rel,
              "one_pass_voxel_flips": one_flips}
    if not rel < C6_REL:
        raise AssertionError(f"segmentation rel deviation {rel:.2e} >= {C6_REL} ({detail})")
    if flips > max(1, on // 500):
        raise AssertionError(f"{flips} thresholded-voxel flips vs {on} on-voxels ({detail})")
    return detail, {"dense": d_default, "sparse": sparse}


def sparse_density_wire(state: dict) -> dict:
    """C7: the sparse wire's compaction scattered on the host against the
    dense maps, bit for bit."""
    dense = state["dense"].cpu().numpy()
    vals, idxs, counts = (t.cpu().numpy() for t in state["sparse"])
    cap = vals.shape[1]
    if counts.max() > cap:
        raise AssertionError(f"count {counts.max()} > cap {cap} on the chunk")
    recon = np.zeros_like(dense).reshape(dense.shape[0], -1)
    for k in range(dense.shape[0]):
        c = int(counts[k])
        recon[k, idxs[k, :c]] = vals[k, :c]
    recon = recon.reshape(dense.shape)
    if not np.array_equal(recon, dense):
        raise AssertionError("sparse reconstruction differs")
    sparse_bytes = int(counts.sum()) * 8 + counts.nbytes
    return {"maps": int(dense.shape[0]), "max_count": int(counts.max()), "cap": cap,
            "transfer_shrink": dense.nbytes / max(sparse_bytes, 1)}


def published_net_and_pocket(device, tmp: Path):
    """C6's network (the published width, the JAX package's random
    parameters) and its parsed synthetic pocket."""
    from ..module import PharmacoNet
    from ..synthetic import write_synthetic_site

    net = PharmacoNet(weight_path=None, verbose=False, device=device)
    protein, ligand = write_synthetic_site(tmp / "site")
    return net, net.parse(protein, ligand)


# --------------------------------------------------------------------------
# The battery
# --------------------------------------------------------------------------
class Battery:
    """Runs checks in order; a failure is recorded with its traceback and
    the battery goes on."""

    def __init__(self):
        self.results: dict[str, dict] = {}

    def run(self, name: str, fn) -> None:
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            detail, ok = fn() or {}, True
        except Exception as e:  # noqa: BLE001 - the battery reports every check
            detail, ok = {"error": f"{type(e).__name__}: {e}"}, False
            traceback.print_exc()
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        self.results[name] = {"ok": ok, "seconds": dt, **detail, "launches": launches}
        print(f"[{'ok' if ok else 'FAIL'}] {name} ({dt:.1f}s) {detail}", flush=True)


def run_battery(device, fast: bool) -> dict:
    """Every check (C6 and C7 unless `fast`) on `device`; returns the summary."""
    battery = Battery()
    model = battery_model()
    tmp = Path(tempfile.mkdtemp(prefix="chip_ci_"))
    store = tmp / "tiles"
    try:
        battery.run("C1_kernel_vs_matcher", lambda: kernel_vs_matcher(device, model))

        def c2():
            write_battery_store(store, model, device)
            return leaf_store_vs_dfs(store, model, device)

        battery.run("C2_leaf_store_vs_dfs", c2)
        battery.run("C3_leaf_einsum_f32", lambda: leaf_einsum_f32(store, model, device))
        battery.run("C4_embed_determinism", lambda: embed_determinism(device))
        battery.run("C5_csv_roundtrip", lambda: csv_roundtrip(store, model, device, tmp))
        if not fast:
            state: dict = {}

            def c6():
                detail, chunk_state = seg_precision(*published_net_and_pocket(device, tmp))
                state.update(chunk_state)
                return detail

            def c7():
                if not state:
                    raise AssertionError("C6 did not run")
                return sparse_density_wire(state)

            battery.run("C6_seg_precision", c6)
            battery.run("C7_sparse_density_wire", c7)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results = battery.results
    launches = {k: sum(r["launches"].get(k, 0) for r in results.values())
                for k in launch_counts()}
    return {
        "device": str(device),
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "fast": fast, "n_checks": len(results),
        "n_fail": sum(1 for r in results.values() if not r["ok"]),
        "total_seconds": sum(r["seconds"] for r in results.values()),
        "launches": launches,
        "checks": results,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("chip_ci", description=__doc__.split("\n\n")[0])
    p.add_argument("--fast", action="store_true", help="skip C6 and C7")
    p.add_argument("--device", default="cuda", help="torch device (cuda without a card raises)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    summary = run_battery(resolve_device(args.device), args.fast)
    print(json.dumps(summary), flush=True)
    return 1 if summary["n_fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
