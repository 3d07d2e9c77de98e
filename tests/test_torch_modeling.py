"""Pocket modeling in the port (`pharmaconet_tpu_torch.module.PharmacoNet`)
against the JAX package's `PharmacoNet`, end to end to the `.pm`.

Both packages load one .npz checkpoint of a small network (embed 8,
depths (2, 2), heads (1, 2), window 2, token features 16, grid 32; the
JAX package's random parameters, with the mask logits' bias at 1.0 so that
the density maps sit away from the 0.5 threshold) and model one synthetic
pocket. The cavity gate is opened (focus threshold 0) and the score gate
set to 0.5, which keeps part of the tokens.

Tolerances: the parsed arrays, the gating decisions, the protein mask,
the relative scores and the hotspot list must be equal (the same f32
decisions); features within atol/rtol 1e-5 and the density maps within
atol 1e-5 (both sides compute in full f32 on the CPU and differ only in
summation order); `.pm` node centres and radii within 1e-5.
"""

from __future__ import annotations

import logging
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import save_npz_checkpoint
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.network.convert import (
    random_distributions,
    save_torch_checkpoint,
    state_dict_from_flax,
)
from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 32
KW = dict(verbose=False, max_hotspots=8, segmentation_chunk=4, grid_dim=GRID,
          model_kwargs=SMALL, score_threshold=0.5)
FEATURE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The pocket, the checkpoint, both packages' modules and the JAX
    package's outputs."""
    tmp = tmp_path_factory.mktemp("modeling")
    info = write_synthetic_pocket(tmp / "pocket.pdb", seed=0, cavity_radius=3.0,
                                  num_atoms=1500, outer_radius=24.0)
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    params = jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 3))
    params["params"]["mask_head"]["conv_logits"]["bias"][:] = 1.0
    distributions = random_distributions()
    save_npz_checkpoint(tmp / "small.npz", params, distributions)
    save_torch_checkpoint(tmp / "small.tar", {
        k: v.numpy() for k, v in state_dict_from_flax(params, dict(image_size=GRID, **SMALL)).items()
    }, distributions)

    jax_net = JaxPharmacoNet(weight_path=tmp / "small.npz", **KW)
    jax_net.focus_threshold = 0.0
    data = jax_net.parse(tmp / "pocket.pdb", center=info["center"])
    trunk = jax.tree.map(np.asarray, jax_net.run_trunk(data))
    infos = jax_net.create_density_maps(data)
    return SimpleNamespace(tmp=tmp, info=info, pdb=tmp / "pocket.pdb", data=data, trunk=trunk,
                           infos=infos, jax_net=jax_net)


def _port(case, **kw) -> PharmacoNet:
    net = PharmacoNet(weight_path=case.tmp / "small.npz", device="cpu", **{**KW, **kw})
    net.focus_threshold = 0.0
    return net


@pytest.fixture(scope="module")
def port(case):
    return _port(case)


def _assert_same_hotspots(got, want, map_tol=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["nci_type"], a["hotspot_type"], a["point_type"]) == (
            b["nci_type"], b["hotspot_type"], b["point_type"])
        assert a["hotspot_position"] == b["hotspot_position"]
        assert abs(a["hotspot_score"] - b["hotspot_score"]) <= 1e-6
        np.testing.assert_allclose(a["point_map"], b["point_map"], atol=map_tol, rtol=0)


def test_synthetic_pocket_parses_in_both_packages(case, port):
    assert 1000 <= case.info["num_atoms"] <= 1600
    data = port.parse(case.pdb, center=case.info["center"])
    for name in ("atom_positions", "atom_features", "atom_valid", "tokens", "token_valid",
                 "token_positions", "center"):
        np.testing.assert_array_equal(getattr(data, name), getattr(case.data, name), err_msg=name)
    assert data.pdbblock == case.data.pdbblock
    assert data.token_valid.sum() >= 100 and data.atom_valid.sum() == case.info["num_atoms"]


def test_full_size_synthetic_pocket(tmp_path):
    """The default pocket: 2,500-4,000 heavy atoms (the 4096 atom bucket),
    at least 100 tokens inside the 64^3 box, non-bonded atoms >= 1.2 A
    apart, and an empty cavity at the centre."""
    info = write_synthetic_pocket(tmp_path / "p.pdb", seed=1)
    net = SimpleNamespace(grid_dim=64, get_center=PharmacoNet.get_center)
    data = PharmacoNet.parse(net, tmp_path / "p.pdb", center=info["center"])
    assert 2500 <= data.atom_valid.sum() <= 4000 and data.atom_positions.shape[0] == 4096
    assert data.token_valid.sum() >= 100
    pos = data.atom_positions[data.atom_valid]
    gaps = np.linalg.norm(pos[:, None] - pos[None], axis=-1) + np.eye(len(pos)) * 9
    assert gaps.min() >= 1.2
    assert np.linalg.norm(pos - np.asarray(info["center"]), axis=1).min() >= 5.5


def test_trunk_outputs_match_jax(case, port):
    out = port.run_trunk(case.data)
    want = case.trunk
    for name in ("keep", "rel_scores", "protein_mask", "cavity_narrow", "cavity_wide"):
        np.testing.assert_array_equal(out[name].numpy(), want[name], err_msg=name)
    assert 0 < want["keep"].sum() < case.data.token_valid.sum()
    np.testing.assert_allclose(out["abs_scores"].numpy(), want["abs_scores"], **FEATURE_TOL)
    np.testing.assert_allclose(out["token_features"].numpy(), want["token_features"],
                               **FEATURE_TOL)
    for got, w in zip(out["pyramid"], want["pyramid"]):
        assert tuple(got.shape) == w.shape
        np.testing.assert_allclose(got.numpy(), w, **FEATURE_TOL)


def test_density_maps_match_jax(case, port):
    infos = port.create_density_maps(case.data)
    assert len(infos) > 4  # more than one chunk of segmentation
    _assert_same_hotspots(infos, case.infos)


def test_pm_from_run_matches_jax(case, port, tmp_path):
    center = case.info["center"]
    got = port.run(case.pdb, center=center)
    got.save(str(tmp_path / "port.pm"))
    got = pickle.loads((tmp_path / "port.pm").read_bytes())
    want = case.jax_net.run(case.pdb, center=center).__getstate__()
    assert got["pdbblock"] == want["pdbblock"] == case.data.pdbblock
    assert len(got["nodes"]) == len(want["nodes"]) > 0
    for a, b in zip(got["nodes"], want["nodes"]):
        for key in ("index", "type", "interaction_type", "hotspot_position",
                    "neighbor_edge_dict", "overlapped_nodes"):
            assert a[key] == b[key], key
        assert abs(a["score"] - b["score"]) <= 1e-6
        np.testing.assert_allclose(a["center"], b["center"], atol=1e-5)
        assert abs(a["radius"] - b["radius"]) <= 1e-5
    assert len(got["edges"]) == len(want["edges"])
    for a, b in zip(got["edges"], want["edges"]):
        assert (a["node_indices"], a["edge_type"]) == (b["node_indices"], b["edge_type"])
        np.testing.assert_allclose([a["distance_mean"], a["distance_std"]],
                                   [b["distance_mean"], b["distance_std"]], atol=1e-5)
    assert {k: [c["node_indices"] for c in v] for k, v in got["node_cluster_dict"].items()} == \
        {k: [c["node_indices"] for c in v] for k, v in want["node_cluster_dict"].items()}


def test_postprocess_matches_jax():
    """The post-processing functions against the JAX package's on the same
    inputs: box masks and the compaction equal, smoothed and thresholded
    maps within atol 1e-6 with equal nonzero masks."""
    from pharmaconet_tpu.ops import postprocess as jpp
    from pharmaconet_tpu_torch.ops import postprocess as pp

    rng = np.random.default_rng(11)
    dim, k = 16, 6
    logits = rng.normal(0, 2, size=(k, dim, dim, dim)).astype(np.float32)
    tokens = np.concatenate([rng.integers(0, dim, size=(k, 3)), rng.integers(0, 10, size=(k, 1))],
                            axis=1).astype(np.int32)
    protein = rng.random((dim, dim, dim)) < 0.8
    cavity = rng.random((dim, dim, dim)) < 0.7
    np.testing.assert_array_equal(pp.gaussian_kernel_1d(), jpp.gaussian_kernel_1d())
    np.testing.assert_array_equal(pp.box_area_mask(torch.from_numpy(tokens), dim).numpy(),
                                  np.asarray(jpp.box_area_mask(tokens, dim)))
    maps = 1 / (1 + np.exp(-logits))
    np.testing.assert_allclose(pp.gaussian_smooth(torch.from_numpy(maps)).numpy(),
                               np.asarray(jpp.gaussian_smooth(maps)), atol=1e-6, rtol=0)
    got = pp.postprocess_density(*map(torch.from_numpy, (logits, tokens, protein, cavity))).numpy()
    want = np.array(jpp.postprocess_density(logits, tokens, protein, cavity))
    np.testing.assert_array_equal(got > 0, want > 0)
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for cap in (4096, 5):  # 5: every map overflows
        for a, b in zip(pp.sparse_compact(torch.from_numpy(want), cap),
                        jpp.sparse_compact(want, cap)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sparse_and_dense_wires_are_bit_identical(case, port):
    """Both density wires rebuild the same maps bit for bit, also when
    every map overflows the sparse cap (cap 3: dense copies per map)."""
    dense = _port(case, density_wire="dense").create_density_maps(case.data)
    assert dense
    for net in (port, _port(case, sparse_transfer_cap=3)):
        sparse = net.create_density_maps(case.data)
        assert len(sparse) == len(dense)
        for a, b in zip(sparse, dense):
            assert a["hotspot_position"] == b["hotspot_position"]
            assert a["hotspot_score"] == b["hotspot_score"]
            np.testing.assert_array_equal(a["point_map"], b["point_map"])


def test_segmentation_chunk_does_not_change_the_maps(case, port):
    small = port.create_density_maps(case.data)
    big = _port(case, segmentation_chunk=16).create_density_maps(case.data)
    _assert_same_hotspots(big, small)


def test_torch_tar_checkpoint_loads_the_same_network(case, port):
    tar = PharmacoNet(weight_path=case.tmp / "small.tar", device="cpu", **KW)
    for (k, a), (_, b) in zip(port.model.state_dict().items(), tar.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert tar.score_distributions.keys() == port.score_distributions.keys()


def test_random_init_matches_jax():
    """weight_path=None draws the JAX package's random parameters and
    score distributions (and looks nothing up)."""
    net = PharmacoNet(weight_path=None, _random_init_seed=5, device="cpu", **KW)
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    want = state_dict_from_flax(jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 5)),
                                dict(image_size=GRID, **SMALL))
    for k, v in net.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    rng = np.random.default_rng(0)
    for t, d in net.score_distributions.items():
        np.testing.assert_array_equal(d, np.sort(rng.uniform(0, 1, size=1000).astype(np.float32)))


def test_run_extraction_matches_jax(case, port):
    feats, infos = port.run_extraction(case.data)
    want_feats, want_infos = case.jax_net.run_extraction(case.data)
    assert [f.shape for f in feats] == [f.shape for f in want_feats]
    for a, b in zip(feats, want_feats):
        np.testing.assert_allclose(a, b, **FEATURE_TOL)
    assert [i["hotspot_position"] for i in infos] == [i["hotspot_position"] for i in want_infos]
    for a, b in zip(infos, want_infos):
        np.testing.assert_allclose(a["hotspot_feature"], b["hotspot_feature"], **FEATURE_TOL)


def test_precision_is_scoped_to_each_stage(case, port, monkeypatch):
    """The trunk and heads run with TF32 off, the mask decoder with TF32 on
    (its default), and every flag is back as it was after `run`."""
    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                          torch.get_float32_matmul_precision())
            return fn(*a, **k)
        monkeypatch.setattr(port.model, name, wrapped)

    spy("forward_feature", port.model.forward_feature)
    spy("forward_segmentation", port.model.forward_segmentation)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    port.run(case.pdb, center=case.info["center"])
    assert seen["forward_feature"] == (False, False, "highest")
    assert seen["forward_segmentation"] == (True, True, "high")
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before


def test_cuda_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PharmacoNet(weight_path=case.tmp / "small.npz", **KW)  # default device


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def _cli(argv):
    from pharmaconet_tpu_torch.cli.modeling import build_parser, main

    return main(build_parser().parse_args(argv))


@pytest.fixture
def small_cli(case, monkeypatch):
    """The CLI builds the small network of this file (it has no flag for a
    reduced architecture) and opens the cavity gate."""
    import pharmaconet_tpu_torch.module as module

    made = []

    class Small(module.PharmacoNet):
        def __init__(self, **kwargs):
            kwargs.update({k: v for k, v in KW.items() if k != "verbose"})
            super().__init__(**kwargs)
            self.focus_threshold = 0.0
            made.append(kwargs)

    monkeypatch.setattr(module, "PharmacoNet", Small)
    return made


def test_cli_center_run_writes_pm_and_caches(case, port, small_cli, tmp_path, caplog):
    x, y, z = case.info["center"]
    argv = ["-p", str(case.pdb), "--center", str(x), str(y), str(z), "--prefix", "poc",
            "--out_dir", str(tmp_path), "--weight_path", str(case.tmp / "small.npz"),
            "--device", "cpu"]
    assert _cli(argv) == 0
    pm = tmp_path / f"poc_{x}_{y}_{z}_model.pm"
    assert pm.exists() and len(small_cli) == 1
    assert small_cli[0]["device"] == "cpu" and small_cli[0]["matmul_precision"] == "float32"
    assert small_cli[0]["segmentation_precision"] == "tensorfloat32"
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

    model = PharmacophoreModel.load(str(pm))
    want = port.run(case.pdb, center=(x, y, z))
    assert [n.center for n in model.nodes] == [n.center for n in want.nodes]
    assert (tmp_path / f"poc_{x}_{y}_{z}_model_pymol.pml").exists() or \
        (tmp_path / f"poc_{x}_{y}_{z}_model_pymol.pse").exists()
    mtime = pm.stat().st_mtime_ns
    with caplog.at_level(logging.WARNING):
        assert _cli(argv) == 0
    assert len(small_cli) == 1  # cached: no network built
    assert pm.stat().st_mtime_ns == mtime and "exists" in caplog.text


def test_cli_ref_ligand_centres_the_box(case, port, small_cli, tmp_path):
    """--ref_ligand: the box centre is the ligand's heavy-atom centroid (as
    the JAX package computes it) and the .pm is named after the ligand."""
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.synthetic import _to_sdf

    c = np.asarray(case.info["center"])
    coords = [tuple(c + d) for d in ((0.7, 0.0, 0.0), (-0.7, 0.1, 0.0), (0.0, 1.2, 0.3))]
    lig = tmp_path / "lig.sdf"
    lig.write_text(_to_sdf("lig", ["C", "C", "O"], coords, [(0, 1, 1), (0, 2, 1)]))
    centre = port.get_center(lig)
    assert centre == JaxPharmacoNet.get_center(lig)
    argv = ["-p", str(case.pdb), "--ref_ligand", str(lig), "--prefix", "poc", "--out_dir",
            str(tmp_path), "--weight_path", str(case.tmp / "small.npz"), "--device", "cpu"]
    assert _cli(argv) == 0
    model = PharmacophoreModel.load(str(tmp_path / "poc_lig_model.pm"))
    want = port.run(case.pdb, center=centre)
    assert [n.center for n in model.nodes] == [n.center for n in want.nodes]


@pytest.mark.parametrize("extra", [["--pdb", "6OIM"], ["--shard"], ["--profile", "trace"], []],
                         ids=["pdb", "shard", "profile", "no-center"])
def test_cli_unported_options_exit_2(case, small_cli, tmp_path, extra, capsys):
    argv = ["-p", str(case.pdb), "--out_dir", str(tmp_path), "--device", "cpu", *extra]
    if extra:
        argv += ["--center", "1", "2", "3"]
    assert _cli(argv) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert small_cli == []
