"""The port's sharded docking-proxy scorer and cache builder
(`pharmaconet_tpu_torch.parallel.proxy`) against the port's single-device
proxies and the JAX package's sharded ones.

Meshes of CPU devices (`[torch.device("cpu")] * n`) run the sharding logic
on the host; the JAX side runs on the conftest's virtual CPU devices.
Scorer: both proxies at the published widths with the flax init the JAX
proxies' `_init_random` draws, carried into the port, on a random pyramid
cut to sides 4-12 (the convolutions do not depend on the side). Builder:
the micro trunk of `test_torch_training.py` (grid 16, gates open) on
copies of one synthetic pocket at four centres, plus a missing file.

Tolerances: sharded scores against `_scoring_list` rtol 1e-4 / atol 1e-5
(each share is padded to other buckets, so sums run in another order: the
JAX package's `tests/test_parallel.py` bound); against the JAX sharded
scorer the repo tolerance rtol 2e-5 / atol 1e-4; the sharded database
equals the port's serial one element by element (the same kernels on the
same arrays) and the JAX builder's at the repo tolerance, as
`test_torch_feature_extraction.py` holds the fused cache to the JAX one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.parallel.mesh import data_mesh as jax_data_mesh
from pharmaconet_tpu.parallel.proxy import ShardedCacheBuilder as JaxShardedCacheBuilder
from pharmaconet_tpu.parallel.proxy import ShardedProxyScorer as JaxShardedProxyScorer
from pharmaconet_tpu.proxy import proxies as jproxies
from pharmaconet_tpu.proxy import sbddreward as jsbdd
from pharmaconet_tpu.proxy import tacogfn as jtaco
from pharmaconet_tpu.proxy.data import batch_graphs as jax_batch_graphs
from pharmaconet_tpu.proxy.data import smi2graph_list as jax_smi2graph_list
from pharmaconet_tpu_torch.parallel import mesh
from pharmaconet_tpu_torch.parallel.proxy import ShardedCacheBuilder, ShardedProxyScorer
from pharmaconet_tpu_torch.proxy.convert import state_dict_from_flax
from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy
from test_torch_training import micro_setup

SHARD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=2e-5, atol=1e-4)
SIDES = (4, 6, 8, 10, 12)
POOL = ["c1ccccc1O", "CCO", "CC(=O)O", "c1ccncc1", "CCN(CC)CC", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
        "O=C(C)Oc1ccccc1C(=O)O"]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pyramid(sides, channels, token_dim, k, seed):
    rng = np.random.default_rng(seed)
    features = [rng.normal(0, 1, (1, d, d, d, channels)).astype(np.float32) for d in sides]
    infos = [{"hotspot_feature": rng.normal(0, 1, token_dim).astype(np.float32),
              "hotspot_position": tuple(rng.uniform(-5, 5, 3).tolist())} for _ in range(k)]
    return features, infos


def _pair(kind: str, features, infos, **model_kwargs):
    """(port proxy on the CPU, JAX proxy) with the same parameters: the
    flax init the JAX proxies' `_init_random` draws (as `tests/test_parallel.py`
    scores with), carried into the port."""
    hot = jnp.asarray(np.stack([i["hotspot_feature"] for i in infos]))
    feats = [jnp.asarray(f) for f in features]
    smiles = jax_smi2graph_list(["CCO"])
    if kind == "taco":
        jcls, cls, jmod = jproxies.TacoGFN_Proxy, TacoGFN_Proxy, jtaco.TacoAffinityHead()
        args = (feats, hot, jtaco.graph_batch_to_arrays(jax_batch_graphs(smiles)))
    else:
        jcls, cls, jmod = jproxies.SBDDReward_Proxy, SBDDReward_Proxy, jsbdd.SBDDRewardNetwork()
        pos = jnp.asarray(np.array([i["hotspot_position"] for i in infos], np.float32))
        args = (feats, hot, pos, jtaco.graph_batch_to_arrays(jax_batch_graphs(smiles), False))
    params = jax.jit(lambda key: jmod.init(key, *args))(jax.random.PRNGKey(3))
    port = cls(device="cpu", model_kwargs=model_kwargs or None)
    port.load_state_dict(state_dict_from_flax(port.model, jax.tree.map(np.array, params)))
    jax_proxy = jcls()
    jax_proxy.params = params
    return port, jax_proxy


@pytest.fixture(scope="module", params=["taco", "sbdd"])
def scorer_case(request):
    features, infos = _pyramid(SIDES, 96, 192, 5, seed=3)
    port, jax_proxy = _pair(request.param, features, infos)
    cache = port._get_cache(features, infos)
    port.put_cache("t", cache)
    return request.param, port, jax_proxy, cache


def test_data_mesh():
    assert mesh.data_mesh([CPU, "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="at least one"):
        mesh.data_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.data_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedProxyScorer(SBDDReward_Proxy(device="cpu"))
    assert mesh.contiguous_shares(37, 3) == [(0, 12), (12, 24), (24, 37)]


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_scores_equal_single_device_and_jax(scorer_case, n_dev):
    kind, port, jax_proxy, cache = scorer_case
    smiles = [POOL[i % len(POOL)] for i in range(37)]
    if kind == "sbdd":
        smiles[5] = "not_a_smiles("  # scores 0.0
    sharded = ShardedProxyScorer(port, mesh=[CPU] * n_dev)
    got = sharded._scoring_list(cache, smiles)
    want = port._scoring_list(cache, smiles)
    np.testing.assert_allclose(got, want, **SHARD_TOL)
    np.testing.assert_array_equal(sharded.scoring_list("t", smiles), got)
    if kind == "sbdd":
        assert got[5] == 0.0
    if n_dev == 3:
        jax_sharded = JaxShardedProxyScorer(jax_proxy, mesh=jax_data_mesh(jax.devices()[:3]))
        np.testing.assert_allclose(got, jax_sharded._scoring_list(cache, smiles), **TOL)


def test_contracts_fallback_and_sigma(scorer_case):
    kind, port, _, cache = scorer_case
    sharded = ShardedProxyScorer(port, mesh=[CPU] * 3)
    smiles = [POOL[i % len(POOL)] for i in range(29)]
    # fewer than 2 graphs per device: the proxy's own single-device path
    np.testing.assert_array_equal(sharded._scoring_list(cache, smiles[:5]),
                                  port._scoring_list(cache, smiles[:5]))
    if kind == "taco":
        with pytest.raises(ValueError, match="unparseable"):
            sharded._scoring_list(cache, smiles[:-1] + ["not_a_smiles("])
        with pytest.raises(TypeError, match="no sigma head"):
            sharded._scoring_list(cache, smiles, return_sigma=True)
        with pytest.raises(TypeError, match="no sigma head"):
            next(sharded.scoring_iter("t", smiles, return_sigma=True))
    else:
        np.testing.assert_array_equal(sharded._scoring_list(cache, ["c11", "C1CC"]), [0.0, 0.0])
        np.testing.assert_allclose(sharded._scoring_list(cache, smiles, return_sigma=True),
                                   port._scoring_list(cache, smiles, return_sigma=True),
                                   **SHARD_TOL)
    assert sharded._scoring_list(cache, []).shape == (0,)


def test_scoring_iter_equals_scoring_list(scorer_case):
    _, port, _, cache = scorer_case
    sharded = ShardedProxyScorer(port, mesh=[CPU] * 3)
    smiles = [POOL[i % len(POOL)] for i in range(37)]
    chunks = list(sharded.scoring_iter("t", iter(smiles), batch_size=16))
    assert [len(c) for c in chunks] == [16, 16, 5]  # the last one takes the fallback
    for i, chunk in enumerate(chunks):
        np.testing.assert_array_equal(chunk, sharded.scoring_list("t", smiles[16 * i:16 * i + 16]))
    np.testing.assert_allclose(np.concatenate(chunks), port._scoring_list(cache, smiles),
                               **SHARD_TOL)
    assert list(sharded.scoring_iter("t", iter([]))) == []
    early = sharded.scoring_iter("t", iter(smiles), batch_size=8)
    next(early)
    early.close()  # stops after the batch in flight


@pytest.fixture(scope="module")
def builder_case(tmp_path_factory):
    setup = micro_setup(tmp_path_factory.mktemp("builder"))
    features, infos = setup.jax_net.feature_extraction(setup.protein_dir / "pocket0.pdb",
                                                       center=setup.centers["pocket0"])
    pocket_info = {code: (setup.protein_dir / f"{code}.pdb", setup.centers[code])
                   for code in setup.codes}
    pocket_info["bad"] = (setup.root / "absent.pdb", setup.centers["pocket0"])
    pairs = {}
    for kind in ("taco", "sbdd"):
        port, jax_proxy = _pair(kind, features, infos, token_dim=16, feature_dim=8, num_scales=3)
        port.pmnet, jax_proxy.pmnet = setup.port, setup.jax_net
        pairs[kind] = port, jax_proxy
    return setup, pairs, pocket_info


@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_cache_builder_equals_serial_and_jax(builder_case, kind, capsys, monkeypatch):
    setup, pairs, pocket_info = builder_case
    port, jax_proxy = pairs[kind]
    serial = port.get_cache_database(dict(pocket_info), verbose=False)
    assert "bad" in capsys.readouterr().out
    trunk_runs = []
    run_trunk = setup.port.run_trunk
    monkeypatch.setattr(setup.port, "run_trunk", lambda d: trunk_runs.append(1) or run_trunk(d))
    sharded = ShardedCacheBuilder(port, mesh=[CPU] * 3).get_cache_database(
        dict(pocket_info), verbose=False)
    assert "bad" in capsys.readouterr().out
    assert len(trunk_runs) == 4  # the trunk (voxelizer included) once per good pocket
    assert sorted(sharded) == sorted(serial) == sorted(setup.codes)
    for key in serial:
        for a, b in zip(sharded[key], serial[key], strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
    if kind == "taco":  # the JAX builder's masked token summary
        want = JaxShardedCacheBuilder(jax_proxy, mesh=jax_data_mesh(jax.devices()[:3])
                                      ).get_cache_database(dict(pocket_info), verbose=False)
        assert sorted(want) == sorted(sharded)
        for key in want:
            for a, b in zip(sharded[key], want[key], strict=True):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL, err_msg=key)


def test_cache_builder_saves_the_database(builder_case, tmp_path):
    setup, pairs, pocket_info = builder_case
    port, _ = pairs["sbdd"]
    db = ShardedCacheBuilder(port, mesh=[CPU] * 2).get_cache_database(
        {k: pocket_info[k] for k in setup.codes[:3]}, save_path=tmp_path / "db.pkl",
        verbose=False)
    loaded = SBDDReward_Proxy._load_cache_file(tmp_path / "db.pkl")
    assert sorted(loaded) == sorted(db) == setup.codes[:3]
    for a, b in zip(loaded["pocket1"], db["pocket1"], strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
