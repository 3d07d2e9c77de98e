"""bench_torch.py, the port's screening benchmark, against the JAX package.

At 10 clusters x 64 ligands x 4 conformers (numpy seeds), every kernel-mode
engine's outputs on the CPU (the plain versions the kernel wrappers run for
CPU tensors) are held against the JAX function on the same inputs, the
Pallas bodies in interpret mode: rtol 2e-5 / atol 1e-4 with equal -1 masks.
`xla` is held against the JAX `score_blocks_device`, `v3-leaf` against K2
and the JAX `leaf2_scores_multi` on a sparse-wire and a dense-wire store
(and `leaf2_scores_device` on the single layout). Each engine and mode runs
through `run` to a JSON line with `correct: true`; a perturbed output or
score makes the gate exit 1 with no metric line.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from pharmaconet_tpu.ops import screen_pallas as jops
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring import leaf_tree as jlt
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_cuda
from pharmaconet_tpu_torch.scoring.batch_screen import PackedModel

RTOL, ATOL = 2e-5, 1e-4
CLUSTERS, LIGANDS, CONFORMERS = 10, 64, 4
CPU = torch.device("cpu")


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(autouse=True)
def no_bench_knobs(monkeypatch):
    """Each test sets the BENCH_* knobs it reads."""
    for name in ("BENCH_MODE", "BENCH_ENGINE", "BENCH_SHAPE", "BENCH_CONF", "BENCH_STORE",
                 "BENCH_LEAVES", "BENCH_LEAF_LAYOUT", "BENCH_LEAF_WIRE", "BENCH_THREADS"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def inputs():
    pm = PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=CLUSTERS))
    return pm, synthetic.make_synthetic_ligands(LIGANDS, num_conformers=CONFORMERS)


def _j(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


def jax_outputs(eng: bench_torch.Engine) -> tuple:
    """The JAX package's outputs for the engine's own inputs, in the
    engine's output order ([rows, C] where the port returns rows)."""
    h = eng.host
    if eng.name == "pallas-dt":
        tb, t = h["tb"], eng.tiles
        return (jops.score_tiles_fused_dt_rows(*_j(h["dt"], tb.gtab[:t], tb.aux[:t]),
                                               tb.depth1, tb.depth2, interpret=True),)
    if eng.name in ("v3", "v3-leaf"):
        b = h["vb"] if eng.name == "v3" else h["sb"]
        rows = jops.score_tiles_v3_rows(*_j(b.dt, b.gid, b.tab, b.aux), depth=b.depth,
                                        mn_cap=b.mn_cap, g_cap=b.tab.shape[1], interpret=True)
        if eng.name == "v3":
            return (rows,)
        (out_ends,) = _j(b.leaf2_out_ends)
        if b.leaf_buckets is not None:
            buckets = tuple(_j(*bk) for bk in b.leaf_buckets)
            return (rows, *jlt.leaf2_scores_multi(rows, out_ends, buckets, nb=b.leaf_nb))
        flat = _j(b.leaf2_ends, b.leaf2_ps, b.leaf2_pc, b.leaf2_pw, b.leaf_conf)
        return (rows, *jlt.leaf2_scores_device(rows, *flat, out_ends,
                                               w_cap=b.leaf2_pw.shape[1]))
    if eng.name in ("pallas", "pallas-split"):
        td = h["tiled"]
        g = _j(td.pos_blocks, td.uv_packed, td.muT, td.invT, td.winvT)
        rows = _j(td.flags_block, td.flags_pair, td.end_mn_inv, td.end_mn_half,
                  td.end_fail_gate, td.thr_ns, td.self_ns)
        kw = dict(depth1=td.depth1, depth2=td.depth2, interpret=True)
        if eng.name == "pallas":
            return (jops.score_blocks_pallas_fused(*g, *rows, **kw),)
        return (jops.gaussian_phase_pallas(*g, interpret=True),
                jops.score_blocks_pallas(*g, *rows, **kw))
    d1, d2 = h["depths"]
    return (jbs.score_blocks_device(*_j(*h["args"]), depth1=d1, depth2=d2),)


ENGINE_CASES = [
    ("pallas-dt", "buckets", "sparse"), ("v3", "buckets", "sparse"),
    ("v3-leaf", "buckets", "sparse"), ("v3-leaf", "buckets", "dense"),
    ("v3-leaf", "single", "dense"), ("pallas", "buckets", "sparse"),
    ("pallas-split", "buckets", "sparse"), ("xla", "buckets", "sparse"),
]


@pytest.mark.parametrize("engine,layout,wire", ENGINE_CASES,
                         ids=[f"{e}-{lay}-{w}" if e == "v3-leaf" else e
                              for e, lay, w in ENGINE_CASES])
def test_engine_matches_jax(inputs, tmp_path, engine, layout, wire):
    pm, ligands = inputs
    eng = bench_torch.make_engine(engine, pm, ligands, CPU, str(tmp_path), layout, wire)
    outs = eng.call()
    want = jax_outputs(eng)
    assert len(outs) == len(want)
    for got, w in zip(outs, want):
        assert_close(got.numpy(), w)
    if engine == "v3-leaf" and layout == "buckets":
        arity = {len(b) for b in eng.host["sb"].leaf_buckets}
        assert arity == {7 if wire == "sparse" else 6}
        specs = [bench_torch.bucket_shape(b) for b in eng.host["sb"].leaf_buckets]
        assert all(bk > 0 and lk > 0 and wk > 0 for bk, lk, wk in specs)
    # final scores, through the host tail or the leaf chain, equal the
    # JAX reference engine's
    jax_scores = jbs.BatchScreener(jbs.PackedModel.from_model(
        bench.make_synthetic_model(num_clusters=CLUSTERS)), engine="xla").score_packed(
        bench.make_synthetic_ligands(LIGANDS, num_conformers=CONFORMERS))
    np.testing.assert_allclose(eng.finish(outs), jax_scores, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", bench_torch.ENGINES)
def test_kernel_mode_runs_behind_its_gate(engine):
    r = bench_torch.run("kernel", engine, batch_size=LIGANDS, iters=1, device="cpu",
                        clusters=CLUSTERS, conformers=CONFORMERS)
    assert r["correct"] is True and r["device"] == "cpu"
    assert (r["metric"], r["unit"]) == ("graph_match_screening_throughput", "ligands/sec/chip")
    assert r["mode"] == "kernel" and r["engine"] == engine and r["batch_size"] == LIGANDS
    assert r["value"] > 0 and r["ms"] > 0 and r["stream_ms"] is None
    assert r["max_abs_err"] == 0.0  # the same plain versions on the CPU
    assert r["max_score_err"] <= ATOL
    assert r["launches"] == {}  # CPU tensors never reach a kernel
    assert "vs_baseline" not in r


@pytest.mark.parametrize("mode,kw", [
    ("host", {}), ("e2e", {}), ("stored", dict(store="v2")), ("stored", dict(store="v3")),
    ("stored", dict(store="v3", leaves=False)), ("proxy", {}),
], ids=["host", "e2e", "stored-v2", "stored-v3", "stored-v3-noleaves", "proxy"])
def test_other_modes_run_behind_their_gates(mode, kw):
    n = 8 if mode == "proxy" else LIGANDS
    r = bench_torch.run(mode, batch_size=n, iters=1, device="cpu", clusters=CLUSTERS, **kw)
    assert r["correct"] is True and r["value"] > 0 and r["batch_size"] == n
    assert (r["metric"], r["unit"]) == bench_torch.METRICS[mode]
    if mode == "stored":
        want = {"v2": "v2", "v3": "v3+leaves"}[kw["store"]] if kw.get("leaves", True) else "v3"
        assert r["store"] == want


def test_conformer_groups_and_env_knobs(monkeypatch, capsys):
    """BENCH_CONF=12 (more conformers than one launch takes) through main,
    the knobs read from the environment as bench.py reads them."""
    monkeypatch.setenv("BENCH_ENGINE", "v3")
    monkeypatch.setenv("BENCH_SHAPE", str(CLUSTERS))
    monkeypatch.setenv("BENCH_CONF", "12")
    assert bench_torch.main([str(LIGANDS // 2), "1", "--device", "cpu"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (r["engine"], r["conformers"], r["clusters"], r["correct"]) == ("v3", 12, CLUSTERS, True)
    assert bench_torch.options_from_env({}) == dict(
        mode="kernel", engine="pallas-dt", clusters=20, conformers=4, store="v2", leaves=True,
        leaf_layout="buckets", leaf_wire="sparse", threads=1)


def _off_by(fn, delta):
    return lambda *a, **k: fn(*a, **k) + delta


@pytest.mark.parametrize("case", ["kernel_output", "leaf_chain", "final_scores", "e2e_scores"])
def test_gate_miss_exits_nonzero(monkeypatch, capsys, case):
    from pharmaconet_tpu_torch.scoring import leaf_tree

    env = {"kernel_output": ("kernel", "pallas-dt"), "leaf_chain": ("kernel", "v3-leaf"),
           "final_scores": ("kernel", "pallas"), "e2e_scores": ("e2e", "pallas-dt")}[case]
    monkeypatch.setenv("BENCH_MODE", env[0])
    monkeypatch.setenv("BENCH_ENGINE", env[1])
    monkeypatch.setenv("BENCH_SHAPE", str(CLUSTERS))
    if case == "kernel_output":
        monkeypatch.setattr(screen_cuda, "score_tiles_fused_dt_rows",
                            _off_by(screen_cuda.score_tiles_fused_dt_rows, 1e-3))
    elif case == "leaf_chain":
        multi = leaf_tree.leaf2_scores_multi
        monkeypatch.setattr(leaf_tree, "leaf2_scores_multi",
                            lambda *a, **k: tuple(t + 1e-3 for t in multi(*a, **k)))
    else:
        ref = bench_torch.reference_scores
        monkeypatch.setattr(bench_torch, "reference_scores",
                            lambda *a: [s + 1e-3 for s in ref(*a)])
    assert bench_torch.main([str(LIGANDS), "1", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out.strip() == "" and "gate missed" in out.err


@pytest.mark.parametrize("kw", [dict(mode="fast"), dict(engine="pallas-x"), dict(store="v9"),
                                dict(leaf_layout="flat"), dict(leaf_wire="bits")])
def test_unknown_knob_values_raise(kw):
    with pytest.raises(ValueError, match="unknown"):
        bench_torch.run(batch_size=4, iters=1, device="cpu", **kw)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run("kernel", batch_size=4, iters=1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["4", "1"])


def test_inputs_are_bench_pys():
    assert synthetic.SMILES_POOL == bench._SMILES_POOL
    assert (bench_torch.PROXY_SIDES, bench_torch.PROXY_CHANNELS, bench_torch.PROXY_HOTSPOTS) == (
        (4, 8, 16, 32, 64), 96, 16)
    features, infos = bench_torch.proxy_inputs()
    rng = np.random.default_rng(0)  # bench.py's draws, in its order
    for f, d in zip(features, (4, 8, 16, 32, 64)):
        np.testing.assert_array_equal(f, rng.normal(0, 1, (1, d, d, d, 96)).astype(np.float32))
    for info in infos:
        np.testing.assert_array_equal(info["hotspot_feature"],
                                      rng.normal(0, 1, 192).astype(np.float32))
        assert info["hotspot_position"] == tuple(rng.uniform(-5, 5, 3).tolist())
