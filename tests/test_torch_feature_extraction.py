"""Feature extraction and the proxies' pocket caches in the port against
the JAX package, on one synthetic pocket.

Both packages load one .npz checkpoint of a small network (embed 8, depths
(2, 2), heads (1, 2), window 2, token features 16, grid 32: a 3-level
pyramid of 8 channels; the JAX package's random parameters) with the
cavity gate open (focus threshold 0), as `test_torch_modeling.py` does.
The proxies take that pyramid (`model_kwargs`: token_dim 16, feature_dim
8, num_scales 3) with random values in every flax leaf.

Tolerances: the `.npz` keys, hotspot positions and types equal; features
within atol/rtol 1e-5 (both packages compute in f32 on the CPU and differ
only in summation order, as in `test_torch_modeling.py`); caches within
the repo tolerance, rtol 2e-5 / atol 1e-4; fused and unfused caches of
the port within the same.
"""

from __future__ import annotations

import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import save_npz_checkpoint
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu.proxy import proxies as jproxies
from pharmaconet_tpu.proxy import sbddreward as jsbdd
from pharmaconet_tpu.proxy import tacogfn as jtaco
from pharmaconet_tpu.proxy.data import batch_graphs as jax_batch_graphs
from pharmaconet_tpu.proxy.data import smi2graph_list as jax_smi2graph_list
from pharmaconet_tpu_torch import api
from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.network.convert import random_distributions
from pharmaconet_tpu_torch.proxy.convert import state_dict_from_flax
from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy
from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket
from test_torch_proxy import _random_leaves

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 32
KW = dict(max_hotspots=8, segmentation_chunk=4, grid_dim=GRID, model_kwargs=SMALL)
PROXY_WIDTHS = dict(token_dim=16, feature_dim=8, num_scales=3)
FEATURE_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores, and 8 threads a worker made these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("features")
    info = write_synthetic_pocket(tmp / "pocket.pdb", seed=0, cavity_radius=3.0,
                                  num_atoms=1500, outer_radius=24.0)
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    params = jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 3))
    save_npz_checkpoint(tmp / "small.npz", params, random_distributions())
    port = api.get_pmnet_dev(device="cpu", weight_path=tmp / "small.npz", **KW)
    port.focus_threshold = 0.0
    from pharmaconet_tpu.api import get_pmnet_dev as jax_get_pmnet_dev

    jax_net = jax_get_pmnet_dev(weight_path=tmp / "small.npz", **KW)
    jax_net.focus_threshold = 0.0
    features, infos = jax_net.feature_extraction(tmp / "pocket.pdb", center=info["center"])
    return SimpleNamespace(tmp=tmp, pdb=tmp / "pocket.pdb", center=info["center"], port=port,
                           jax_net=jax_net, features=features, infos=infos)


def test_get_pmnet_dev(case):
    """The flat 0.5 threshold of the JAX package's get_pmnet_dev, quiet, on
    the device asked for; its feature extraction equals the JAX one."""
    assert case.port.device == torch.device("cpu") and case.port.verbose is False
    assert case.port.score_threshold == case.jax_net.score_threshold
    assert set(case.port.score_threshold.values()) == {0.5}
    features, infos = case.port.feature_extraction(case.pdb, center=case.center)
    assert [f.shape for f in features] == [np.shape(f) for f in case.features]
    assert len(features) == 3 and features[0].shape == (1, 8, 8, 8, 8)
    for a, b in zip(features, case.features):
        np.testing.assert_allclose(a, b, **FEATURE_TOL)
    assert [i["hotspot_position"] for i in infos] == [i["hotspot_position"] for i in case.infos]
    assert len(infos) > 4


def test_get_pmnet_dev_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_pmnet_dev()


@pytest.fixture
def small_clis(case, monkeypatch):
    """Both CLIs build the small network of this file (they have no flag for
    a reduced architecture) with the cavity gate open."""
    import pharmaconet_tpu.api as jax_api

    made = []

    def small(cls):
        class Small(cls):
            def __init__(self, **kwargs):
                made.append(kwargs)
                super().__init__(**{**kwargs, **KW})
                self.focus_threshold = 0.0
        return Small

    monkeypatch.setattr(api, "PharmacoNet", small(PharmacoNet))
    monkeypatch.setattr(jax_api, "PharmacoNet", small(JaxPharmacoNet))
    monkeypatch.setenv("PMNET_TPU_NO_COMPILE_CACHE", "1")
    return made


def _run_cli(module, argv):
    return module.main(module.build_parser().parse_args(argv))


def test_cli_npz_and_pt_match_jax(case, small_clis, tmp_path):
    from pharmaconet_tpu.cli import feature_extraction as jax_cli
    from pharmaconet_tpu_torch.cli import feature_extraction as cli

    x, y, z = case.center
    common = ["-p", str(case.pdb), "--center", str(x), str(y), str(z), "--weight_path",
              str(case.tmp / "small.npz")]
    assert _run_cli(cli, [*common, "-o", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    assert small_clis[-1]["device"] == "cpu"
    assert _run_cli(jax_cli, [*common, "-o", str(tmp_path / "jax.npz")]) == 0
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    assert int(got["num_hotspots"]) == int(want["num_hotspots"]) > 4
    for key in want.files:
        assert got[key].dtype == want[key].dtype, key
        if key.endswith(("_position", "_nci_type")) or key == "num_hotspots":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        elif key.endswith("_score"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], **FEATURE_TOL, err_msg=key)

    assert _run_cli(cli, [*common, "-o", str(tmp_path / "port.pt"), "--device", "cpu"]) == 0
    features, infos = torch.load(tmp_path / "port.pt", weights_only=False)
    assert len(features) == 3 and len(infos) == int(got["num_hotspots"])
    for i, f in enumerate(features):
        assert isinstance(f, torch.Tensor)
        np.testing.assert_array_equal(f.numpy(), got[f"feature_{i}"])
    for i, info in enumerate(infos):
        assert isinstance(info["hotspot_feature"], torch.Tensor)
        np.testing.assert_array_equal(info["hotspot_feature"].numpy(),
                                      got[f"hotspot_{i}_feature"])
        assert info["nci_type"] == str(got[f"hotspot_{i}_nci_type"])
        assert {"hotspot_type", "point_type", "hotspot_score", "hotspot_position"} <= set(info)


def test_cli_cuda_without_card_raises(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from pharmaconet_tpu_torch.cli import feature_extraction as cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_cli(cli, ["-p", str(case.pdb), "--center", "0", "0", "0", "-o",
                       str(tmp_path / "f.npz")])


# --------------------------------------------------------------------------
# Proxy caches on the pocket: fused = unfused = the JAX package's
# --------------------------------------------------------------------------
def _proxy_pair(case, kind: str):
    feats = [jnp.asarray(f) for f in case.features]
    hot = jnp.zeros((2, 16))
    if kind == "taco":
        jcls, cls, jmod = jproxies.TacoGFN_Proxy, TacoGFN_Proxy, jtaco.TacoAffinityHead()
        batch = jtaco.graph_batch_to_arrays(jax_batch_graphs(jax_smi2graph_list(["CCO"])))
        args = (feats, hot, batch)
    else:
        jcls, cls, jmod = jproxies.SBDDReward_Proxy, SBDDReward_Proxy, jsbdd.SBDDRewardNetwork()
        batch = jtaco.graph_batch_to_arrays(jax_batch_graphs(jax_smi2graph_list(["CCO"])), False)
        args = (feats, hot, jnp.zeros((2, 3)), batch)
    shapes = jax.eval_shape(lambda key: jmod.init(key, *args), jax.random.PRNGKey(0))
    params = {"params": _random_leaves(shapes["params"], np.random.default_rng(4))}
    jax_proxy = jcls()
    jax_proxy.params = jax.tree.map(jnp.asarray, params)
    jax_proxy.pmnet = case.jax_net
    port = cls(device="cpu", model_kwargs=PROXY_WIDTHS)
    port.load_state_dict(state_dict_from_flax(port.model, params))
    port.pmnet = case.port
    return port, jax_proxy


def _assert_caches_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, float):
            assert isinstance(a, float) and abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
        else:
            assert np.shape(a) == np.shape(b)
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_get_cache_fused_unfused_and_jax(case, kind):
    port, jax_proxy = _proxy_pair(case, kind)
    fused = port.get_cache(case.pdb, center=case.center)
    unfused = port.get_cache(case.pdb, center=case.center, fused=False)
    _assert_caches_close(fused, unfused)
    want = jax_proxy.get_cache(case.pdb, center=case.center)
    _assert_caches_close(fused, want)
    assert np.shape(fused[1])[0] == len(case.infos) > 4  # one row per kept hotspot
    scores = port._scoring_list(fused, ["c1ccccc1", "CCO"])
    np.testing.assert_allclose(scores, jax_proxy._scoring_list(want, ["c1ccccc1", "CCO"]), **TOL)


def test_get_cache_database(case, tmp_path, capsys):
    """One cache per pocket; a pocket that fails is printed and skipped;
    the saved database loads back in the port."""
    port, _ = _proxy_pair(case, "sbdd")
    info = {"a": (case.pdb, case.center), "broken": (tmp_path / "absent.pdb", case.center),
            "b": (case.pdb, tuple(c + 0.5 for c in case.center))}
    db = port.get_cache_database(info, save_path=tmp_path / "db.pkl", verbose=False)
    assert sorted(db) == ["a", "b"] and "broken" in capsys.readouterr().out
    _assert_caches_close(db["a"], port.get_cache(case.pdb, center=case.center))
    loaded = SBDDReward_Proxy._load_cache_file(tmp_path / "db.pkl")
    with open(tmp_path / "db.pkl", "rb") as f:
        assert pickle.load(f).keys() == loaded.keys()
    _assert_caches_close(loaded["b"], db["b"])
