"""The port's docking proxies (`pharmaconet_tpu_torch.proxy`) against the
JAX package's, module by module and end to end.

Every flax module is initialised with random values in every leaf (so a
misplaced tensor shows: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.05),
norm scales in [0.5, 1.5], embeddings and GINE's eps ~ N(0, 1)), applied
to seeded numpy inputs, and the same tree is carried into the port with
`proxy.convert.state_dict_from_flax`. The pyramid is cut to sides
4/6/8/10/12 (the convolutions do not depend on the side); widths are the
published ones.

Tolerance: rtol 2e-5 / atol 1e-4 (the repo's score tolerance) for every
module and both proxies end to end. Both sides compute in f32 on the CPU
and differ in summation order and in the LayerNorm variance (flax uses
E[x^2] - E[x]^2, torch the two-pass form). Measured on the CPU, the
largest difference takes 15% of the tolerance (atol + rtol |x|): 7.3e-4
on graph features of magnitude up to 1.8e3 (the categorical encoder's
readout under these random leaves); end-to-end caches and scores take at
most 7% of it (1.8e-4 on SBDD scores up to 144). So nothing is held
looser than the repo tolerance, the LayerNorms included.
bfloat16 is held within the JAX tests' bound of float32 (rtol 5e-2, atol
0.3; `tests/test_proxy.py`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.proxy import gnn as jgnn
from pharmaconet_tpu.proxy import proxies as jproxies
from pharmaconet_tpu.proxy import sbddreward as jsbdd
from pharmaconet_tpu.proxy import tacogfn as jtaco
from pharmaconet_tpu.proxy.data import batch_graphs as jax_batch_graphs
from pharmaconet_tpu.proxy.data import smi2graph_list as jax_smi2graph_list
from pharmaconet_tpu_torch.proxy import gnn, sbddreward, tacogfn
from pharmaconet_tpu_torch.proxy.convert import state_dict_from_flax
from pharmaconet_tpu_torch.proxy.data import batch_graphs, half_octave, smi2graph_list
from pharmaconet_tpu_torch.proxy.proxies import (
    SBDDReward_Proxy,
    TacoGFN_Proxy,
    get_docking_proxy,
)

TOL = dict(rtol=2e-5, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=0.3)
SIDES = (4, 6, 8, 10, 12)
SMILES = ["c1ccccc1", "C1CCCCC1", "CCO", "N[C@@H](C)C(=O)[O-]", "O=S(=O)(N)c1ccc(I)cc1",
          "CC(C)(C)C(=O)N[C@@H](Cc1ccccc1)C", "[Se]1C=CC=C1", "C#N"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores, and 8 threads a worker made these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_leaves(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_leaves(v, rng)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "bias":
            out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1])) if k == "kernel" else 1
            out[k] = rng.normal(0, fan_in**-0.5, v.shape).astype(np.float32)
    return out


def _init(flax_module, *inputs, seed=0):
    """Random values in every leaf of the module's parameter tree (the
    inputs stay concrete: the batch's graph count is a static size)."""
    shapes = jax.eval_shape(lambda key: flax_module.init(key, *inputs),
                            jax.random.PRNGKey(seed))["params"]
    return {"params": _random_leaves(shapes, np.random.default_rng(seed))}


def _port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_flax(module, params), strict=True)
    return module.eval().requires_grad_(False)


def _close(got, want, **tol) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **(tol or TOL))
    return float(np.abs(got - want).max()) if got.size else 0.0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def pocket():
    rng = np.random.default_rng(0)
    features = [rng.normal(0, 1, (1, d, d, d, 96)).astype(np.float32) for d in SIDES]
    infos = [{"hotspot_feature": rng.normal(0, 1, 192).astype(np.float32),
              "hotspot_position": tuple(rng.uniform(-8, 8, 3).tolist())} for _ in range(6)]
    return features, infos


def _batches(categorical: bool, smiles=SMILES, num_graphs_pad=None):
    jb = jax_batch_graphs(jax_smi2graph_list(smiles), num_graphs_pad=num_graphs_pad)
    tb = batch_graphs(smi2graph_list(smiles), num_graphs_pad=num_graphs_pad)
    return jtaco.graph_batch_to_arrays(jb, categorical), tacogfn.graph_batch_to_arrays(
        tb, categorical)


# --------------------------------------------------------------------------
# Modules against flax apply
# --------------------------------------------------------------------------
def test_gine_conv_matches_flax():
    rng = np.random.default_rng(1)
    jarr, tarr = _batches(True)
    v, e = jarr[0].shape[0], jarr[3].shape[0]
    x = rng.normal(0, 1, (v, 128)).astype(np.float32)
    attr = rng.normal(0, 1, (e, 128)).astype(np.float32)
    args = (x, jarr[3], jarr[4], attr, jarr[6])
    params = _init(jgnn.GINEConv(128), *args)
    conv = _port(gnn.GINEConv(128), params)
    assert float(conv.eps) != 0.0
    _close(conv(_t(x), tarr[3], tarr[4], _t(attr), tarr[6]),
           jgnn.GINEConv(128).apply(params, *args))


@pytest.mark.parametrize("categorical", [True, False], ids=["embedding", "dense"])
def test_graph_encoder_matches_flax(categorical):
    jarr, tarr = _batches(categorical, num_graphs_pad=12)
    out_dim = 256 if categorical else 128
    jmod = jgnn.GraphEncoder(hidden_dim=128, out_dim=out_dim, categorical=categorical)
    params = _init(jmod, jarr)
    enc = _port(gnn.GraphEncoder(128, out_dim, categorical=categorical), params)
    x, z = enc(tarr)
    jx, jz = jmod.apply(params, jarr)
    _close(x, jx)
    _close(z, jz)
    assert z.shape[0] == 12 and torch.all(z[len(SMILES):] == z[-1])  # empty graphs


def test_sorted_segment_sum_drops_the_sentinel():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([0, 0, 2, 2, 2, 3])  # segment 1 empty, 3 = sentinel
    got = gnn.sorted_segment_sum(x, ids, 3)
    want = torch.zeros(4, 2).index_add_(0, ids, x)[:3]
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def taco_params(pocket):
    features, infos = pocket
    jarr, _ = _batches(True)
    hot = np.stack([i["hotspot_feature"] for i in infos])
    return _init(jtaco.TacoAffinityHead(), features, hot, jarr)


@pytest.mark.parametrize("k", [6, 0], ids=["k6", "k0"])
def test_taco_head_matches_flax(pocket, taco_params, k):
    features, infos = pocket
    hot = np.stack([i["hotspot_feature"] for i in infos])[:k].reshape(k, 192)
    jmod = jtaco.TacoAffinityHead()
    head = _port(tacogfn.TacoAffinityHead(), taco_params)
    pocket_v, token = head.ready_to_calculate([_t(f) for f in features], _t(hot))
    jp, jt = jmod.apply(taco_params, features, hot, method="ready_to_calculate")
    _close(pocket_v, jp)
    _close(token, jt)
    # the padded-axis form: 3 padding rows that must not count
    pad = np.concatenate([hot, np.ones((3, 192), np.float32)])
    valid = np.arange(k + 3) < k
    mp, mt = head.ready_to_calculate_masked([_t(f) for f in features], _t(pad), _t(valid))
    jmp, _ = jmod.apply(taco_params, features, pad, valid, method="ready_to_calculate_masked")
    _close(mp, jmp)
    _close(mp, jp)
    _close(mt[:k], jt)

    jarr, tarr = _batches(True, num_graphs_pad=12)
    got = head.calculate_affinity(pocket_v, token, tarr)
    want = jmod.apply(taco_params, jp, jt, jarr, method="calculate_affinity")
    _close(got, want)


@pytest.fixture(scope="module")
def sbdd_params(pocket):
    features, infos = pocket
    jarr, _ = _batches(False)
    hot = np.stack([i["hotspot_feature"] for i in infos])
    pos = np.array([i["hotspot_position"] for i in infos], np.float32)
    return _init(jsbdd.SBDDRewardNetwork(), features, hot, pos, jarr)


def test_one_hot_distance_matches_jax():
    x = np.array([-1.0, 0.0, 1.99, 2.0, 5.5, 29.9, 30.0, 31.0, 31.5, 100.0], np.float32)
    got = sbddreward.one_hot_distance(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsbdd.one_hot_distance(x)))


def _complex_inputs(seed=2, v=40, k=6, c=128):
    rng = np.random.default_rng(seed)
    z = rng.normal(0, 1, (v, k, c)).astype(np.float32)
    b = rng.normal(0, 1, (k, k, c)).astype(np.float32)
    mask = (np.arange(v) < v - 7).astype(np.float32)  # 7 padding rows
    return z, b, mask


@pytest.mark.parametrize("name", ["TriangleMultiplicativeUpdate", "TriangleAttention",
                                  "PairTransition", "ComplexFormerBlock"])
def test_complexformer_modules_match_flax(name):
    z, b, mask = _complex_inputs()
    jmod = getattr(jsbdd, name)()
    args = {"TriangleMultiplicativeUpdate": (z, b, mask), "ComplexFormerBlock": (z, b, mask)}.get(
        name, (z, mask))
    params = _init(jmod, *args)
    mod = _port(getattr(sbddreward, name)(), params)
    _close(mod(*map(_t, args)), jmod.apply(params, *args))


def test_pharmacophore_encoder_matches_flax(pocket, sbdd_params):
    features, infos = pocket
    hot = np.stack([i["hotspot_feature"] for i in infos])
    pos = np.array([i["hotspot_position"] for i in infos], np.float32)
    params = {"params": sbdd_params["params"]["pharmacophore_encoder"]}
    enc = _port(sbddreward.PharmacophoreEncoder(), params)
    x, p, z = enc([_t(f) for f in features], _t(hot), _t(pos))
    jx, jp, jz = jsbdd.PharmacophoreEncoder().apply(params, features, hot, pos)
    _close(x, jx)
    _close(z, jz)
    assert torch.equal(p, _t(pos))


@pytest.mark.parametrize("k", [6, 0], ids=["k6", "k0"])
def test_sbdd_network_matches_flax(pocket, sbdd_params, k):
    features, infos = pocket
    hot = np.stack([i["hotspot_feature"] for i in infos])[:k].reshape(k, 192)
    pos = np.array([i["hotspot_position"] for i in infos], np.float32)[:k].reshape(k, 3)
    jmod = jsbdd.SBDDRewardNetwork()
    net = _port(sbddreward.SBDDRewardNetwork(), sbdd_params)
    cache = net.get_cache([_t(f) for f in features], _t(hot), _t(pos))
    jcache = jmod.apply(sbdd_params, features, hot, pos, method="get_cache")
    for a, b in zip(cache, jcache):
        _close(a, b)
    assert -15.0 <= float(cache[3]) <= 0.0 and 0.0 <= float(cache[4]) <= 5.0
    jarr, tarr = _batches(False, num_graphs_pad=12)
    for sigma in (False, True):
        _close(net.scoring(cache, tarr, sigma), jmod.apply(sbdd_params, jcache, jarr, sigma,
                                                           method="scoring"))
    # the head alone, on the encoders' outputs
    x_lig, z_lig = net.ligand_encoder(tarr)
    jx_lig, jz_lig = jgnn.GraphEncoder(128, 128, categorical=False).apply(
        {"params": sbdd_params["params"]["ligand_encoder"]}, jarr)
    head = {"params": sbdd_params["params"]["head"]}
    _close(net.head.cal_sigma(*cache[:3], x_lig, z_lig, tarr[1], tarr[2], tarr[7]),
           jsbdd.SBDDAffinityHead().apply(head, *jcache[:3], jx_lig, jz_lig, jarr[1], jarr[2],
                                          jarr[7], method="cal_sigma"))


# --------------------------------------------------------------------------
# Proxies end to end against the JAX proxies with the same parameters
# --------------------------------------------------------------------------
def _proxies(cls, jcls, params, **kw):
    port = cls(device="cpu", **kw)
    port.load_state_dict(state_dict_from_flax(port.model, params))
    jax_proxy = jcls(**kw)
    jax_proxy.params = jax.tree.map(jnp.asarray, params)
    return port, jax_proxy


@pytest.fixture(scope="module")
def taco(taco_params):
    return _proxies(TacoGFN_Proxy, jproxies.TacoGFN_Proxy, taco_params)


@pytest.fixture(scope="module")
def sbdd(sbdd_params):
    return _proxies(SBDDReward_Proxy, jproxies.SBDDReward_Proxy, sbdd_params)


def _assert_cache_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, float):
            assert isinstance(a, float) and abs(a - b) <= TOL["atol"] + TOL["rtol"] * abs(b)
        else:
            _close(a, b)


@pytest.mark.parametrize("k", [6, 0], ids=["k6", "k0"])
@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_proxy_cache_and_scores_match_jax(request, pocket, kind, k):
    port, jax_proxy = request.getfixturevalue(kind)
    features, infos = pocket
    cache = port._get_cache(features, infos[:k])
    want = jax_proxy._get_cache([jnp.asarray(f) for f in features], infos[:k])
    _assert_cache_close(cache, want)
    _close(port._scoring_list(cache, SMILES), jax_proxy._scoring_list(want, SMILES))


@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_solo_equals_batched(request, pocket, kind):
    """One molecule alone and inside a padded batch score the same (the JAX
    tests' bound); padding never contributes."""
    port, _ = request.getfixturevalue(kind)
    features, infos = pocket
    cache = port._get_cache(features, infos)
    batched = port._scoring_list(cache, SMILES)
    solo = np.concatenate([port._scoring_list(cache, [s]) for s in SMILES])
    np.testing.assert_allclose(batched, solo, rtol=2e-4, atol=1e-5)
    assert half_octave(len(SMILES[:5])) > 5  # graph-axis padding in play
    np.testing.assert_allclose(port._scoring_list(cache, SMILES[:5]), batched[:5],
                               rtol=2e-4, atol=1e-5)


def test_invalid_smiles(taco, sbdd, pocket):
    features, infos = pocket
    with pytest.raises(ValueError, match="unparseable"):
        taco[0]._scoring_list(taco[0]._get_cache(features, infos), ["CCO", "c11"])
    port, jax_proxy = sbdd
    cache = port._get_cache(features, infos)
    got = port._scoring_list(cache, ["c1ccccc1", "c11", "CCO", "C("])
    assert got[1] == 0.0 and got[3] == 0.0
    _close(got, jax_proxy._scoring_list(cache, ["c1ccccc1", "c11", "CCO", "C("]))
    np.testing.assert_array_equal(port._scoring_list(cache, ["c11", "C("]), np.zeros(2))


def test_return_sigma_and_statistic(sbdd, pocket):
    port, jax_proxy = sbdd
    features, infos = pocket
    port.put_cache("tgt", port._get_cache(features, infos))
    jax_proxy.put_cache("tgt", port._cache["tgt"])
    mu, std = port.get_statistic("tgt")
    assert (mu, std) == jax_proxy.get_statistic("tgt")
    sigma = port.scoring_list("tgt", SMILES, return_sigma=True)
    _close(sigma, jax_proxy.scoring_list("tgt", SMILES, return_sigma=True))
    np.testing.assert_allclose(port.scoring_list("tgt", SMILES), sigma * std + mu, rtol=1e-5)
    np.testing.assert_allclose(port.scoring("tgt", "CCO"), port.scoring_list("tgt", ["CCO"]))


@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_precision_settings(request, pocket, kind):
    """tensorfloat32 equals float32 on the CPU (no TF32 there; the card's
    difference is measured by chip_smoke.py); bfloat16 casts parameters
    and activations, returns float32 within the JAX tests' bound of
    float32, and stays within that bound of the JAX package's bfloat16."""
    port, jax_proxy = request.getfixturevalue(kind)
    features, infos = pocket
    cache = port._get_cache(features, infos)
    want = port._scoring_list(cache, SMILES)
    state = port.model.state_dict()
    cls, jcls = type(port), type(jax_proxy)
    tf = cls(device="cpu", precision="tensorfloat32")
    tf.load_state_dict(state)
    np.testing.assert_array_equal(tf._scoring_list(cache, SMILES), want)
    bf = cls(device="cpu", precision="bfloat16")
    bf.load_state_dict(state)
    got = bf._scoring_list(cache, SMILES)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert not np.array_equal(got, want)  # a real cast, not the f32 path
    np.testing.assert_allclose(got, want, **BF16_TOL)
    jbf = jcls(precision="bfloat16")
    jbf.params = jax_proxy.params
    np.testing.assert_allclose(got, jbf._scoring_list(cache, SMILES), **BF16_TOL)
    assert all(p.dtype == torch.float32 for p in bf.model.parameters())  # params untouched
    with pytest.raises(ValueError, match="precision"):
        cls(device="cpu", precision="float16")


def test_precision_scopes(sbdd, pocket, monkeypatch):
    """The cache path runs with TF32 off for matrix products and cuDNN;
    scoring in the proxy's precision; the flags come back after."""
    port, _ = sbdd
    features, infos = pocket
    seen = {}
    for name in ("get_cache", "scoring"):
        fn = getattr(port.model, name)

        def spy(*a, _fn=fn, _name=name, **k):
            seen[_name] = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            return _fn(*a, **k)
        monkeypatch.setattr(port.model, name, spy)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    try:
        cache = port._get_cache(features, infos)
        port.precision = "tensorfloat32"
        port._scoring_list(cache, ["CCO"])
    finally:
        port.precision = "float32"
        assert torch.backends.cudnn.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    assert seen == {"get_cache": (False, False), "scoring": (True, True)}


def test_random_init_is_reproducible():
    a, b, c = (SBDDReward_Proxy(device="cpu") for _ in range(3))
    a._init_random(3)
    b._init_random(3)
    c._init_random(4)
    sa, sb, sc = (p.model.state_dict() for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert float(sa["head.blocks.0.tri_attention.layer_norm.weight"].mean()) == 1.0


# --------------------------------------------------------------------------
# Upstream checkpoints and local artifacts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["taco", "sbdd"])
def test_upstream_checkpoint_through_both_converters(pocket, tmp_path, kind):
    """A synthesized upstream state dict goes through the JAX converter
    into flax and through the port's loader into the port: same caches
    and scores. The upstream tensors the network does not use
    (`head.linear_distance`) are left out."""
    from test_proxy_convert import _synth_sbdd_state, _synth_tacogfn_state

    rng = np.random.default_rng(7)
    if kind == "taco":
        state = _synth_tacogfn_state(rng)
        ckpt = {"model": {k: torch.from_numpy(v) for k, v in state.items()}}
        cls, jcls, flax = TacoGFN_Proxy, jproxies.TacoGFN_Proxy, jtaco.convert_tacogfn_checkpoint
    else:
        state = _synth_sbdd_state(rng)
        ckpt = {k: torch.from_numpy(v) for k, v in state.items()}
        cls, jcls, flax = (SBDDReward_Proxy, jproxies.SBDDReward_Proxy,
                           jsbdd.convert_sbddreward_checkpoint)
    for key in state:  # non-trivial biases and norms, so a misplaced one shows
        if key.endswith(".bias") or key.endswith(".eps"):
            state[key][...] = rng.normal(0, 0.05, state[key].shape)
    torch.save(ckpt, tmp_path / "model.pth")
    port = cls(tmp_path / "model.pth", device="cpu")
    jax_proxy = jcls()
    jax_proxy.params = jax.tree.map(jnp.asarray, flax(state))
    features, infos = pocket
    cache = port._get_cache(features, infos)
    want = jax_proxy._get_cache([jnp.asarray(f) for f in features], infos)
    _assert_cache_close(cache, want)
    _close(port._scoring_list(cache, SMILES), jax_proxy._scoring_list(want, SMILES))
    if kind == "sbdd":
        del state["head.mlp_mu.0.weight"]
        with pytest.raises(KeyError, match="mlp_mu"):
            sbddreward.convert_sbddreward_checkpoint(state)


def test_load_from_local_files(pocket, tmp_path, monkeypatch):
    """get_docking_proxy / load read $PMNET_TPU_HOME/proxies/<class>/ and
    the cache database; a missing artifact raises naming its path and
    Google Drive id; nothing is fetched."""
    from test_proxy_convert import _synth_tacogfn_state

    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path))
    home = tmp_path / "proxies" / "TacoGFN_Proxy"
    with pytest.raises(RuntimeError, match="1Kjn4xNc8458Ibf-ckWjtuUotuhGFLiHK") as err:
        get_docking_proxy("TacoGFN_Reward", "QVina", "CrossDocked2020", None, device="cpu")
    assert str(home / "model-QVina-CrossDocked2020.pth") in str(err.value)
    home.mkdir(parents=True)
    state = _synth_tacogfn_state(np.random.default_rng(0))
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               home / "model-QVina-CrossDocked2020.pth")
    with pytest.raises(RuntimeError, match="1Ps3-Mj2GHH_FLtnjAD1riYiRyK01C_T8"):
        get_docking_proxy("TacoGFN_Reward", "QVina", "CrossDocked2020", "test", device="cpu")

    features, infos = pocket
    probe = TacoGFN_Proxy(home / "model-QVina-CrossDocked2020.pth", device="cpu")
    cache = probe._get_cache(features, infos)
    torch.save({"pocket_a": tuple(torch.from_numpy(a) for a in cache)},
               home / "cache-test-QVina-CrossDocked2020.pt")
    proxy = get_docking_proxy("TacoGFN_Reward", "QVina", "CrossDocked2020", "test",
                              device="cpu")
    assert isinstance(proxy, TacoGFN_Proxy) and proxy.device.type == "cpu"
    np.testing.assert_array_equal(proxy.scoring_list("pocket_a", SMILES),
                                  probe._scoring_list(cache, SMILES))
    # a custom database path, written by the port and by the JAX package
    for saver in (TacoGFN_Proxy._save_cache_file, jproxies.TacoGFN_Proxy._save_cache_file):
        saver({"pocket_b": cache}, tmp_path / "db.pkl")
        custom = TacoGFN_Proxy.load("QVina", "CrossDocked2020", tmp_path / "db.pkl",
                                    device="cpu")
        for a, b in zip(custom._cache["pocket_b"], cache):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown proxy"):
        get_docking_proxy("Other", "QVina", "CrossDocked2020", None, device="cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SBDDReward_Proxy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_docking_proxy("SBDDReward", "UniDock_Vina", "ZINC", None)
