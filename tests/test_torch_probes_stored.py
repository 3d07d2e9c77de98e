"""The stored-route and decoder probes (`pharmaconet_tpu_torch/probes/
probe_*.py`, the counterparts of the JAX package's root `probes/`) at tiny
sizes on the CPU.

Every probe's `main` runs once with `--device cpu` (the plain torch
versions of K2, K3 and K6) and its gates pass. The host probes' numbers
equal the JAX probes' own functions on the same pool: `probe_layout_stats`
prints the JAX probe's lines word for word, and `probe_dfs_stats`'s
relaxed and gated searches (`simulate_bfs`, `gated_leafs`, `collect`,
`collect_gated`) give the JAX ones' results on one pair table. K3's plain
version at depth 0 in either scan equals the JAX `score_tiles_fused_dt`
in interpret mode. A score changed on purpose fails the sweep's gate and
`probe_sparse_wire`'s. The JAX probes' records in the repo root stay
untouched.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.ops import screen_pallas as jops
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring.tiled_pack import build_tiled_batch as j_build_tiled
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_ref
from pharmaconet_tpu_torch.probes import (
    probe_conv_ladder,
    probe_dfs_stats,
    probe_gather_variants,
    probe_layout_stats,
    probe_leaf_phases,
    probe_scan_share,
    probe_seg_bf16,
    probe_shape_sweep,
    probe_sparse_split,
    probe_sparse_wire,
    scale,
    stored_route,
)
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import screen_tiles as t_tiles
from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch as t_build_tiled

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-4
RECORDS = ("SPARSE_WIRE.json", "SPARSE_SPLIT.json")
SWEEP = ["--n", "16", "--clusters", "4,10", "--conformers", "4", "--reps", "1"]
WIRE = ["--n", "24", "--num_conformers", "2", "--batch_size", "8", "--spot_checks", "4",
        "--embed_backend", "numpy", "--reps", "1"]
PROBES = {  # module, its tiny arguments; probe_sparse_split reads probe_sparse_wire's stores
    "probe_leaf_phases": (probe_leaf_phases, ["--n", "48", "--reps", "1"]),
    "probe_shape_sweep": (probe_shape_sweep, SWEEP),
    "probe_sparse_wire": (probe_sparse_wire, [*WIRE, "--keep"]),
    "probe_sparse_split": (probe_sparse_split, ["--reps", "1", "--copies", "1"]),
    "probe_gather_variants": (probe_gather_variants, ["--n", "32", "--reps", "1"]),
    "probe_scan_share": (probe_scan_share, ["--n", "32", "--reps", "1"]),
    "probe_seg_bf16": (probe_seg_bf16, ["--arch", "micro", "--n", "4", "--reps", "1"]),
    "probe_conv_ladder": (probe_conv_ladder, ["--n", "1", "--grid", "8", "--reps", "1"]),
    "probe_dfs_stats": (probe_dfs_stats, ["--n", "8"]),
    "probe_layout_stats": (probe_layout_stats, ["--n", "32"]),
}


def _digests() -> dict[str, str]:
    return {name: hashlib.sha256((REPO / name).read_bytes()).hexdigest() for name in RECORDS}


def run_probe(module, argv: list[str], work: Path) -> tuple[int, dict]:
    """(exit code, report) of one probe's main on the CPU in `work`."""
    rc = module.main([*argv, "--device", "cpu", "--work_dir", str(work)])
    return rc, json.loads((work / "report.json").read_text())


@pytest.fixture(scope="module")
def records_before():
    return _digests()


@pytest.fixture(scope="module")
def reports(records_before, tmp_path_factory):
    """{probe: (exit code, report)}, each probe run once in this process."""
    root = tmp_path_factory.mktemp("probes")
    out = {}
    for name, (module, argv) in PROBES.items():
        if name == "probe_sparse_split":
            argv = [*argv, "--stores", str(root / "probe_sparse_wire")]
        out[name] = run_probe(module, argv, root / name)
    return out


def _jax_probe(name: str):
    """A JAX root probe's module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "probes" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_runs_and_its_gates_pass(reports, name):
    rc, report = reports[name]
    assert rc == 0 and report["ok"], report.get("error")
    assert report["probe"] == name and report["device"] == "cpu"
    if name == "probe_leaf_phases":
        assert report["gate"]["bit_equal"]  # D and the CLI run the same chain
        assert set(report["phases"]) == {"A_k2", "B_gather", "C_products", "D_chain"}
        assert set(report["phase_e"]) == {"s_f32", "s_tf32_one_pass", "s_bf16_three_passes"}
        assert report["phase_e"]["s_f32"]["max_abs_dev_s"] == 0.0
    elif name == "probe_shape_sweep":
        assert [(r["clusters"], r["conformers"]) for r in report["rows"]] == [(4, 4), (10, 4)]
        assert all(r["gate"]["max_abs_diff"] <= ATOL for r in report["rows"])
        assert all(r["shared_bytes"] > 0 and r["slots"] > 0 for r in report["rows"])
    elif name == "probe_sparse_wire":
        assert report["csv_gate"]["rows"] == 24
        assert report["store_sparse"]["leaf_bytes"] < report["store_dense"]["leaf_bytes"]
        assert report["spot_check"]["checked"] > 0 and report["spot_check"]["failed"] == 0
    elif name == "probe_sparse_split":
        assert report["dense"]["operand_mb"] > report["sparse"]["operand_mb"]
        assert report["gate"]["bit_equal"]
    elif name == "probe_gather_variants":
        assert set(report["variants"]) == {"g0", "g1", "g2", "g3", "g4", "g5", "window"}
        assert 0 < report["real_slots"] < report["slots"]
    elif name == "probe_scan_share":
        assert set(report["gates"]) == {"full", "depth2_0", "depth1_0", "both_0"}
        assert report["depth1"] > 0 and report["depth2"] > 0
    elif name == "probe_seg_bf16":
        assert report["hotspots"] > 0 and report["modes"]["float32"]["max_diff"] == 0.0
    elif name == "probe_conv_ladder":
        assert report["batch"] == 1 and report["cut_reason"] is None
        assert report["conv96_f32"]["tflops"] is None  # no device rate from a CPU run
    elif name == "probe_dfs_stats":
        assert report["score_gate"]["ligands"] == [0, 1, 7]
        assert set(report["pools"]) == {"synthetic", "sdf", "clusters40"}
    else:
        assert report["stats"]["group_determines_mn"]


def test_layout_stats_equal_the_jax_probe(reports, monkeypatch):
    """probe_layout_stats prints the JAX probe's lines at the same --n."""
    jax_probe = _jax_probe("probe_layout_stats")
    monkeypatch.setattr(sys, "argv", ["probe_layout_stats.py", "32"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jax_probe.main()
    assert "\n".join(reports["probe_layout_stats"][1]["lines"]) == printed.getvalue().rstrip("\n")


def test_dfs_stats_equal_the_jax_functions():
    """On one pair table (the port's reference engine on the CPU), the
    relaxed and gated searches over the JAX batch and the port's batch of
    the same pool give the same numbers and lines."""
    jax_probe = _jax_probe("probe_dfs_stats")
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=20, seed=0))
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=20, seed=0))
    t_batch, table = probe_dfs_stats.table_for(
        t_pm, synthetic.make_synthetic_ligands(6, seed=1), torch.device("cpu"))
    j_batch = jbs.build_batch(j_pm, bench.make_synthetic_ligands(6, seed=1))
    assert j_batch.pair_slices == t_batch.pair_slices
    for li in range(len(t_batch.ligand_clusters)):
        assert probe_dfs_stats.simulate_bfs(t_batch, table, li) == \
            jax_probe.simulate_bfs(j_batch, table, li)
        assert probe_dfs_stats.gated_leafs(t_batch, table, li) == \
            jax_probe.gated_leafs(j_batch, table, li)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jax_probe.collect(j_batch, table, "pool")
        jax_probe.collect_gated(j_batch, table, "pool")
    lines = (probe_dfs_stats.collect(t_batch, table, "pool")[1]
             + probe_dfs_stats.collect_gated(t_batch, table, "pool")[1])
    assert "\n".join(lines) == printed.getvalue().rstrip("\n")


@pytest.fixture(scope="module")
def k3_tiles():
    """The same small tiles from both packages: (JAX tiles, port tiles,
    distances, used tiles)."""
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=10, seed=5))
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=10, seed=5))
    jt = j_build_tiled(j_pm, bench.make_synthetic_ligands(16, num_conformers=3, seed=6))
    tt = t_build_tiled(t_pm, synthetic.make_synthetic_ligands(16, num_conformers=3, seed=6))
    t = -(-tt.nst // 1024)
    return jt, tt, t_tiles.tile_distances(tt.pos_blocks[:t], tt.uv[:t]), t


@pytest.mark.parametrize("setting", ["both_0", "depth2_0", "depth1_0"])
def test_k3_plain_at_depth_zero_matches_jax(k3_tiles, setting):
    """probe_scan_share's settings: K3's plain version with a scan at
    depth 0 equals the interpret-mode Pallas kernel, -1 masks included."""
    jt, tt, dt, t = k3_tiles
    d1 = 0 if setting in ("both_0", "depth1_0") else tt.depth1
    d2 = 0 if setting in ("both_0", "depth2_0") else tt.depth2
    assert tt.depth1 > 0 and tt.depth2 > 0
    want = np.asarray(jops.score_tiles_fused_dt_rows(
        jnp.asarray(dt), jnp.asarray(jt.gtab[:t]), jnp.asarray(jt.aux[:t]), depth1=d1,
        depth2=d2, interpret=True))
    got = screen_ref.score_tiles_fused_dt_rows(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (dt, tt.gtab[:t], tt.aux[:t])),
        d1, d2).numpy()
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sweep_gate_fails_on_a_changed_score(monkeypatch, tmp_path):
    reference = stored_route.reference_scores

    def changed(*args):
        scores = reference(*args)
        top = np.argmax(scores)
        scores[top] += 1e-3 * max(1.0, scores[top])  # 50x the tolerance at any score
        return scores

    monkeypatch.setattr(stored_route, "reference_scores", changed)
    rc, report = run_probe(probe_shape_sweep, SWEEP, tmp_path / "sweep")
    assert rc == 1 and not report["ok"]
    assert "scores against the reference engine" in report["error"]


def test_sparse_wire_gate_fails_on_a_changed_score(monkeypatch, tmp_path):
    read = scale.read_scores

    def changed(path):
        scores = read(path)
        if Path(path).name == "scores_sparse.csv":
            name = max(scores, key=scores.get)
            scores[name] += 1e-3 * max(1.0, scores[name])
        return scores

    monkeypatch.setattr(scale, "read_scores", changed)
    rc, report = run_probe(probe_sparse_wire, WIRE, tmp_path / "wire")
    assert rc == 1 and not report["ok"]
    assert "sparse CSV against dense CSV" in report["error"]


def test_jax_records_untouched(reports, records_before):
    assert _digests() == records_before
