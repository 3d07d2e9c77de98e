"""The port's batch screener against the JAX package and the exact matcher.

Host arrays (packed model, packed ligands, block and tiled batches) must be
element-equal to the JAX package's; scores from every engine branch of
`BatchScreener(device="cpu")` must agree with the JAX
`BatchScreener(engine="xla")` and the exact host GraphMatcher within
rtol 2e-5 / atol 1e-4.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

import bench
from helpers import ACETATE_SDF, BENZENE_SDF, ETHANOL_SDF, _model_state
from pharmaconet_tpu.pharmacophore.model import PharmacophoreModel as JModel
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring.tiled_pack import build_tiled_batch as j_build_tiled
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.chem.smallmol import parse_sdf
from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import tiled_pack
from pharmaconet_tpu_torch.scoring.executor import ScreeningExecutor
from pharmaconet_tpu_torch.scoring.graph_match import GraphMatcher
from pharmaconet_tpu_torch.scoring.ligand import Ligand

RTOL, ATOL = 2e-5, 1e-4
BRANCHES = {
    "tiled": {},
    "native_pack=False": dict(native_pack=False),
    "fused=False": dict(fused=False),
    "reference": dict(engine="reference"),
}
CUSTOM_WEIGHTS = {"Hydrophobic": 2.0, "Anion": 10.0, "HBond_donor": 1.0}

NODES = [
    ("Hydrophobic", "Hydrophobic", (0.0, 0.0, 0.0), 0.9),
    ("Hydrophobic", "Hydrophobic", (1.8, 0.5, 0.0), 1.1),
    ("Aromatic", "PiStacking_P", (4.0, 1.0, 0.5), 1.4),
    ("HBond_donor", "HBond_ldon", (2.5, 3.0, 1.0), 0.8),
    ("HBond_acceptor", "HBond_pdon", (5.5, 3.5, -1.0), 0.8),
    ("Anion", "SaltBridge_lneg", (6.5, 0.0, 2.0), 1.2),
    ("Cation", "PiCation_pring", (-2.0, 2.0, 1.0), 1.0),
]
CLUSTERS = [
    ("Hydrophobic", [0, 1]), ("Aromatic", [2]), ("HBond", [3]), ("HBond", [4]),
    ("Anion", [5]), ("Cation", [6]),
]


@pytest.fixture(scope="module")
def models():
    """The same pocket model loaded by both packages."""
    state = _model_state(NODES, CLUSTERS)
    j, t = JModel(), PharmacophoreModel()
    j.__setstate__(state)
    t.__setstate__(_model_state(NODES, CLUSTERS))
    return j, t


def _make_ligands(parse_sdf, ligand_cls) -> list:
    """Real molecules, some with several rigidly moved conformers and one
    far outside the pocket (prune / fail paths), built with one package's
    parser and Ligand class; the same seeds give the same conformers."""

    def multi(sdf: str, num_conf: int, seed: int):
        mol = parse_sdf(sdf)[0].strip_hydrogens()
        rng = np.random.default_rng(seed)
        base = mol.coords
        confs = [base]
        for _ in range(num_conf - 1):
            theta = rng.uniform(0, 2 * np.pi)
            rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                            [np.sin(theta), np.cos(theta), 0], [0, 0, 1]],
                           dtype=np.float32)
            shifted = base @ rot.T + rng.uniform(-2, 2, size=(1, 3)).astype(np.float32)
            shifted += rng.normal(0, 0.1, size=base.shape).astype(np.float32)
            confs.append(shifted.astype(np.float32))
        return ligand_cls(mol, confs)

    far = parse_sdf(ETHANOL_SDF)[0]
    far.coords = far.coords + np.float32(100.0)
    return [
        ligand_cls(parse_sdf(ETHANOL_SDF)[0]),
        ligand_cls(parse_sdf(BENZENE_SDF)[0]),
        ligand_cls(parse_sdf(ACETATE_SDF)[0]),
        multi(ETHANOL_SDF, 4, seed=1),
        multi(BENZENE_SDF, 3, seed=2),
        multi(ACETATE_SDF, 5, seed=3),
        ligand_cls(far),
    ]


@pytest.fixture(scope="module")
def ligands():
    """(JAX package ligands, port ligands) of the same molecules."""
    from pharmaconet_tpu.chem.smallmol import parse_sdf as j_parse_sdf
    from pharmaconet_tpu.scoring.ligand import Ligand as JLigand

    return _make_ligands(j_parse_sdf, JLigand), _make_ligands(parse_sdf, Ligand)


@pytest.fixture(scope="module")
def synthetic_inputs():
    return (bench.make_synthetic_model(num_clusters=10, seed=5),
            synthetic.make_synthetic_model(num_clusters=10, seed=5),
            bench.make_synthetic_ligands(40, seed=6),
            synthetic.make_synthetic_ligands(40, seed=6))


def _packed_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_packed_model_and_ligands_equal(models, ligands):
    j, t = models
    jpm = jbs.PackedModel.from_model(j, CUSTOM_WEIGHTS)
    tpm = tbs.PackedModel.from_model(t, CUSTOM_WEIGHTS)
    _packed_equal(tpm, jpm)
    # state carried across: the JAX packed model's fields rebuild the port's
    _packed_equal(tbs.PackedModel.from_arrays(vars(jpm)), jpm)
    for jl, tl in zip(*ligands):
        _packed_equal(tbs.PackedLigand.from_ligand(tl), jbs.PackedLigand.from_ligand(jl))


@pytest.mark.parametrize("native", [True, False])
def test_build_batch_equal(synthetic_inputs, native):
    jm, tm, jl, tl = synthetic_inputs
    jb = jbs.build_batch(jbs.PackedModel.from_model(jm), jl, native=native)
    tb = tbs.build_batch(tbs.PackedModel.from_model(tm), tl, native=native)
    for f in dataclasses.fields(tb):
        x, y = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name == "candidates":
            assert [(a, [list(c) for c in cs]) for a, cs in x] == \
                   [(a, [list(c) for c in cs]) for a, cs in y]
        else:
            assert x == y, f.name


def test_build_tiled_batch_equal(synthetic_inputs):
    jm, tm, jl, tl = synthetic_inputs
    jt = j_build_tiled(jbs.PackedModel.from_model(jm), jl)
    tt = tiled_pack.build_tiled_batch(tbs.PackedModel.from_model(tm), tl)
    for f in ("gtab", "aux", "uv", "pos_blocks", "pair_end_rows", "pair_threshold",
              "pair_meta", "num_conformers", "lig_cluster_center", "lig_cluster_size"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    assert (tt.depth1, tt.depth2, tt.nst, tt.ln, tt.cmax) == \
           (jt.depth1, jt.depth2, jt.nst, jt.ln, jt.cmax)
    assert tt.pair_slices == jt.pair_slices


def test_native_host_paths_match_python(synthetic_inputs):
    """Native prep, prune and DFS equal their numpy / Python references."""
    _, tm, _, tl = synthetic_inputs
    scr = tbs.BatchScreener(tm, engine="reference", device="cpu")
    batch = tbs.build_batch(scr.packed_model, tl)
    (a_nat, d_nat), (a_py, d_py) = scr.device_args(batch), scr.device_args(batch, native=False)
    assert d_nat == d_py
    for x, y in zip(a_nat, a_py):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        tbs.host_prune_mask(batch, scr.packed_model),
        tbs.host_prune_mask(batch, scr.packed_model, native=False),
    )
    table = tbs.compact_pair_table(batch, scr.run_device(batch).numpy())
    table[tbs.host_prune_mask(batch, scr.packed_model)] = -1.0
    native = tbs._dfs_scores(batch, table)
    np.testing.assert_allclose(native, tbs._dfs_scores_python(batch, table),
                               rtol=RTOL, atol=ATOL)
    assert tbs._dfs_scores(batch, table, threads=3) == native


@pytest.mark.parametrize("weights", [None, CUSTOM_WEIGHTS], ids=["default", "custom"])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_screener_matches_matcher_and_jax(models, ligands, branch, weights):
    j, t = models
    j_ligs, t_ligs = ligands
    exact = [GraphMatcher(t, lig, weights).run() for lig in t_ligs]
    want = jbs.BatchScreener(j, weights, engine="xla").score_ligands(j_ligs)
    got = tbs.BatchScreener(t, weights, device="cpu", **BRANCHES[branch]).score_ligands(t_ligs)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert max(exact) > 0.0


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_screener_synthetic_batch_matches_jax(synthetic_inputs, branch):
    jm, tm, jl, tl = synthetic_inputs
    want = jbs.BatchScreener(jm, engine="xla").score_packed(jl)
    got = tbs.BatchScreener(tm, device="cpu", **BRANCHES[branch]).score_packed(tl)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert max(want) > 0.0


def test_executor_matches_sequential():
    model = synthetic.make_synthetic_model(num_clusters=10, seed=5)
    packed = synthetic.make_synthetic_ligands(64, seed=6)
    screener = tbs.BatchScreener(model, device="cpu")
    seq = screener.score_packed(packed)
    seen = []
    ovl = ScreeningExecutor(screener, batch_size=16, pack_workers=2).score_packed(
        packed, on_batch=lambda start, scores: seen.append((start, len(scores)))
    )
    assert ovl == seq
    assert seen == [(0, 16), (16, 16), (32, 16), (48, 16)]
    assert max(seq) > 0.0


def test_executor_error_propagates(monkeypatch):
    """A pack-worker failure surfaces as the original exception, with every
    worker thread joined."""
    model = synthetic.make_synthetic_model(num_clusters=8, seed=7)
    packed = synthetic.make_synthetic_ligands(48, seed=8)
    screener = tbs.BatchScreener(model, device="cpu")
    real_build = tiled_pack.build_tiled_batch
    calls = {"n": 0}

    def failing_build(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("synthetic pack failure")
        return real_build(*args, **kwargs)

    monkeypatch.setattr(tiled_pack, "build_tiled_batch", failing_build)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="synthetic pack failure"):
        ScreeningExecutor(screener, batch_size=16, pack_workers=2).score_packed(packed)
    assert threading.active_count() == before
