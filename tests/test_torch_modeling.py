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


def test_random_init_matches_jax(tmp_path, monkeypatch):
    """weight_path=None with no checkpoint provisioned (no PMNET_TPU_WEIGHT,
    an empty PMNET_TPU_HOME) draws the JAX package's random parameters and
    score distributions."""
    monkeypatch.delenv("PMNET_TPU_WEIGHT", raising=False)
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path))
    net = PharmacoNet(weight_path=None, _random_init_seed=5, device="cpu", **KW)
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    want = state_dict_from_flax(jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 5)),
                                dict(image_size=GRID, **SMALL))
    for k, v in net.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    rng = np.random.default_rng(0)
    for t, d in net.score_distributions.items():
        np.testing.assert_array_equal(d, np.sort(rng.uniform(0, 1, size=1000).astype(np.float32)))


def _state_equal(net, want: PharmacoNet) -> bool:
    got = net.model.state_dict()
    return all(torch.equal(v, got[k]) for k, v in want.model.state_dict().items())


def _jax_params_equal(net, want) -> bool:
    a, b = jax.tree.leaves(net.params), jax.tree.leaves(want.params)
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_weight_env_gives_equal_pm_in_both_packages(case, port, tmp_path, monkeypatch):
    """weight_path=None with PMNET_TPU_WEIGHT pointed at the .npz: both
    packages load it (the parameters of an explicit weight_path) and write
    equal .pm files."""
    monkeypatch.setenv("PMNET_TPU_WEIGHT", str(case.tmp / "small.npz"))
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path))
    net = PharmacoNet(weight_path=None, device="cpu", **KW)
    jax_net = JaxPharmacoNet(weight_path=None, **KW)
    assert _state_equal(net, port) and _jax_params_equal(jax_net, case.jax_net)
    net.focus_threshold = jax_net.focus_threshold = 0.0
    center = case.info["center"]
    net.run(case.pdb, center=center).save(str(tmp_path / "port.pm"))
    jax_net.run(case.pdb, center=center).save(str(tmp_path / "jax.pm"))
    got, want = (pickle.loads((tmp_path / f).read_bytes()) for f in ("port.pm", "jax.pm"))
    assert got["pdbblock"] == want["pdbblock"] and len(got["nodes"]) == len(want["nodes"]) > 0
    for a, b in zip(got["nodes"], want["nodes"]):
        assert (a["index"], a["type"], a["hotspot_position"]) == \
            (b["index"], b["type"], b["hotspot_position"])
        assert abs(a["score"] - b["score"]) <= 1e-6
        np.testing.assert_allclose(a["center"], b["center"], atol=1e-5)
    assert [(e["node_indices"], e["edge_type"]) for e in got["edges"]] == \
        [(e["node_indices"], e["edge_type"]) for e in want["edges"]]


@pytest.mark.parametrize("name", ["model.npz", "model.tar"])
def test_weight_home_is_found(case, port, tmp_path, monkeypatch, name):
    """weight_path=None finds $PMNET_TPU_HOME/model.npz (both packages) or
    model.tar (the port; the JAX package reads the upstream tar through
    torch)."""
    import shutil

    monkeypatch.delenv("PMNET_TPU_WEIGHT", raising=False)
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path))
    shutil.copy(case.tmp / ("small.npz" if name == "model.npz" else "small.tar"),
                tmp_path / name)
    assert _state_equal(PharmacoNet(weight_path=None, device="cpu", **KW), port)
    if name == "model.npz":
        assert _jax_params_equal(JaxPharmacoNet(weight_path=None, **KW), case.jax_net)


def test_missing_weight_env_falls_back_to_random_in_both(case, tmp_path, monkeypatch):
    """PMNET_TPU_WEIGHT naming a missing file: both packages fall back to
    the same random parameters (and download nothing), also when
    $PMNET_TPU_HOME holds a checkpoint."""
    import shutil

    from pharmaconet_tpu_torch.utils.download_weight import GDRIVE_URL, resolve_weight_path

    monkeypatch.setenv("PMNET_TPU_WEIGHT", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path))
    shutil.copy(case.tmp / "small.npz", tmp_path / "model.npz")
    with pytest.raises(FileNotFoundError, match="PMNET_TPU_WEIGHT"):
        resolve_weight_path(None)
    net = PharmacoNet(weight_path=None, device="cpu", **KW)
    jax_net = JaxPharmacoNet(weight_path=None, **KW)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_net.params),
                                dict(image_size=GRID, **SMALL))
    for k, v in net.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    assert _jax_params_equal(jax_net, SimpleNamespace(params=JaxPharmacoNet._random_params(
        holder, 0)))
    monkeypatch.delenv("PMNET_TPU_WEIGHT")
    (tmp_path / "model.npz").unlink()
    with pytest.raises(RuntimeError, match=GDRIVE_URL.replace("?", r"\?")):
        resolve_weight_path(None)
    with pytest.raises(FileNotFoundError):
        resolve_weight_path(tmp_path / "absent.tar")


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


@pytest.mark.parametrize("extra", [["--pdb", "6OIM"], []], ids=["pdb", "no-center"])
def test_cli_unported_options_exit_2(case, small_cli, tmp_path, extra, capsys, monkeypatch):
    """--pdb whose download fails (the fetch is stubbed to fail: nothing is
    downloaded in tests) and a PDB with no ligand and no centre given
    (stdin closed) exit 2, before a network is built. (--shard and
    --profile, which exited 2 here before they were ported, are held by
    the tests below.)"""
    import builtins
    import urllib.request

    def no_fetch(*a, **k):
        raise OSError("no network in tests")

    def closed_stdin(prompt=""):
        raise EOFError

    monkeypatch.setattr(urllib.request, "urlopen", no_fetch)
    monkeypatch.setattr(builtins, "input", closed_stdin)
    argv = ["-p", str(case.pdb), "--out_dir", str(tmp_path), "--device", "cpu", *extra]
    if extra:
        argv += ["--center", "1", "2", "3"]
    assert _cli(argv) == 2
    want = "download of 6OIM failed" if extra else "no ligand detected"
    assert want in capsys.readouterr().err
    assert small_cli == []


# --------------------------------------------------------------------------
# --shard, --profile and convert_weights
# --------------------------------------------------------------------------
SITES = [("LIG", "A", 901, (0.0, 0.0, 0.0)), ("MOV", "B", 1, (0.0, 1.4, 1.2)),
         ("ABC", "C", 7, (1.2, -1.0, 0.0))]  # HET ligands, offsets from the pocket centre


@pytest.fixture(scope="module")
def complex_pdb(case, tmp_path_factory):
    """The pocket with three HET ligands in its cavity."""
    from pharmaconet_tpu_torch.synthetic import append_het_ligands

    path = tmp_path_factory.mktemp("sites") / "complex.pdb"
    path.write_text(case.pdb.read_text())
    c = np.asarray(case.info["center"])
    append_het_ligands(path, [(h, ch, r, tuple(c + d)) for h, ch, r, d in SITES])
    return path


@pytest.fixture
def mesh3(monkeypatch):
    """The modeling CLI sees three CPU devices; returns the jobs of each
    ShardedModeler.run_batch call and the pockets of each
    ShardedSegmenter.run call."""
    from pharmaconet_tpu_torch.cli import modeling as cli
    from pharmaconet_tpu_torch.parallel import modeling as par

    monkeypatch.setattr(cli, "_modeling_mesh", lambda args: [torch.device("cpu")] * 3)
    calls = {"run_batch": [], "segmenter": []}
    run_batch, seg_run = par.ShardedModeler.run_batch, par.ShardedSegmenter.run
    monkeypatch.setattr(par.ShardedModeler, "run_batch",
                        lambda self, jobs: calls["run_batch"].append(jobs) or run_batch(self, jobs))
    monkeypatch.setattr(par.ShardedSegmenter, "run",
                        lambda self, *a, **k: calls["segmenter"].append(a) or seg_run(self, *a, **k))
    return calls


def _pm_files(out_dir) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out_dir.glob("*_model.pm"))}


def test_cli_all_shard_batches_uncached_sites(case, small_cli, complex_pdb, mesh3, tmp_path):
    """--all --shard sends the sites that are not cached through
    ShardedModeler.run_batch (one pocket per device); a cached site stays
    out of the batch, every .pm equals the run without --shard, and a
    second run is a pure cache hit (no batch, no network)."""
    common = ["-p", str(complex_pdb), "--all", "--prefix", "cx", "--weight_path",
              str(case.tmp / "small.npz"), "--device", "cpu"]
    assert _cli([*common, "--out_dir", str(tmp_path / "plain")]) == 0
    plain = _pm_files(tmp_path / "plain")
    assert len(plain) == 3 and mesh3["run_batch"] == []
    cached = sorted(plain)[0]
    (tmp_path / "shard").mkdir()
    (tmp_path / "shard" / cached).write_bytes(plain[cached])
    argv = [*common, "--shard", "--out_dir", str(tmp_path / "shard")]
    assert _cli(argv) == 0
    assert [len(jobs) for jobs in mesh3["run_batch"]] == [2]
    assert all(job[0] == str(complex_pdb) for job in mesh3["run_batch"][0])
    assert _pm_files(tmp_path / "shard") == plain
    builds = len(small_cli)
    mesh3["run_batch"].clear()
    assert _cli(argv) == 0  # pure cache hit
    assert mesh3["run_batch"] == [] and mesh3["segmenter"] == [] and len(small_cli) == builds


def test_cli_shard_single_site(case, small_cli, complex_pdb, mesh3, tmp_path, caplog,
                               monkeypatch):
    """--shard on one site fans its segmentation over the devices
    (ShardedSegmenter); with one device visible it logs and runs there.
    Either way the .pm equals the run without --shard."""
    from pharmaconet_tpu_torch.cli import modeling as cli

    common = ["-p", str(complex_pdb), "--ligand_id", "MOV", "--prefix", "cx", "--weight_path",
              str(case.tmp / "small.npz"), "--device", "cpu"]
    assert _cli([*common, "--out_dir", str(tmp_path / "plain")]) == 0
    assert _cli([*common, "--shard", "--out_dir", str(tmp_path / "shard")]) == 0
    assert len(mesh3["segmenter"]) == 1 and mesh3["run_batch"] == []
    plain = _pm_files(tmp_path / "plain")
    assert len(plain) == 1 and _pm_files(tmp_path / "shard") == plain
    monkeypatch.setattr(cli, "_modeling_mesh", lambda args: None)  # one device
    with caplog.at_level(logging.INFO):
        assert _cli([*common, "--shard", "--out_dir", str(tmp_path / "one")]) == 0
    assert "only one device is visible" in caplog.text and len(mesh3["segmenter"]) == 1
    assert _pm_files(tmp_path / "one") == plain


def test_cli_profile_writes_a_trace(case, small_cli, tmp_path):
    """--profile DIR writes a torch.profiler trace (Chrome JSON) of the
    modeling into DIR; the .pm equals a run without it."""
    import json

    x, y, z = case.info["center"]
    common = ["-p", str(case.pdb), "--center", str(x), str(y), str(z), "--prefix", "poc",
              "--weight_path", str(case.tmp / "small.npz"), "--device", "cpu"]
    assert _cli([*common, "--out_dir", str(tmp_path / "plain")]) == 0
    assert _cli([*common, "--out_dir", str(tmp_path / "prof"), "--profile",
                 str(tmp_path / "trace")]) == 0
    assert _pm_files(tmp_path / "prof") == _pm_files(tmp_path / "plain")
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::conv3d") for e in events)


def test_convert_weights_cli_matches_jax(tmp_path, capsys):
    """An upstream-layout tar of the published architecture
    (`synthesize_torch_state_dict`) through both packages' convert_weights:
    the same .npz keys and arrays, and the same report line."""
    from pharmaconet_tpu.cli import convert_weights as jax_cli
    from pharmaconet_tpu_torch.cli import convert_weights as cli
    from pharmaconet_tpu_torch.network.convert import synthesize_torch_state_dict

    save_torch_checkpoint(tmp_path / "model.tar", synthesize_torch_state_dict(3, 0.5),
                          random_distributions())
    lines = []
    for mod, name in ((cli, "port"), (jax_cli, "jax")):
        dst = tmp_path / f"{name}.npz"
        assert mod.main(mod.build_parser().parse_args([str(tmp_path / "model.tar"), str(dst)])) == 0
        lines.append(capsys.readouterr().out.replace(str(dst), "DST"))
    assert lines[0] == lines[1] and "31,030,486 parameters, 10 score distributions" in lines[0]
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) and len(want.files) > 400
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
