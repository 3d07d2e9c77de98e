"""The docking proxies and feature extraction on the card (skipped without
one): the same parameters and inputs on the card and on the CPU, and the
voxelizer K6 launched once per pocket on each path. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_proxy_card.py

Tolerances: caches and scores within the repo tolerance (rtol 2e-5, atol
1e-4) of the CPU's (full f32 on both: the cache path and float32 scoring
turn TF32 off); solo = batched within the JAX tests' bound (rtol 2e-4,
atol 1e-5).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy

pytestmark = pytest.mark.gpu
TOL = dict(rtol=2e-5, atol=1e-4)
SMILES = ["c1ccccc1", "C1CCCCC1", "CCO", "N[C@@H](C)C(=O)[O-]", "O=S(=O)(N)c1ccc(I)cc1",
          "CC(C)(C)C(=O)N[C@@H](Cc1ccccc1)C", "[Se]1C=CC=C1", "C#N"]


@pytest.fixture(autouse=True)
def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pyramid(sides, channels=96, seed=0):
    rng = np.random.default_rng(seed)
    features = [rng.normal(0, 1, (1, d, d, d, channels)).astype(np.float32) for d in sides]
    infos = [{"hotspot_feature": rng.normal(0, 1, 192).astype(np.float32),
              "hotspot_position": tuple(rng.uniform(-8, 8, 3).tolist())} for _ in range(6)]
    return features, infos


def _assert_cache_close(got, want):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("cls", [TacoGFN_Proxy, SBDDReward_Proxy], ids=["taco", "sbdd"])
def test_card_matches_cpu(cls):
    cpu, card = cls(device="cpu"), cls(device="cuda")
    cpu._init_random(5)
    card.load_state_dict(cpu.model.state_dict())
    features, infos = _pyramid((4, 6, 8, 10, 12))
    cache = card._get_cache(features, infos)
    _assert_cache_close(cache, cpu._get_cache(features, infos))
    got = card._scoring_list(cache, SMILES)
    np.testing.assert_allclose(got, cpu._scoring_list(cache, SMILES), **TOL)
    solo = np.concatenate([card._scoring_list(cache, [s]) for s in SMILES])
    np.testing.assert_allclose(got, solo, rtol=2e-4, atol=1e-5)


def test_k6_launches_once_per_pocket(tmp_path):
    """K6 once per feature extraction and per get_cache, fused or not, on a
    small network (embed 8, depths (2, 2), grid 32); the card's cache
    within the repo tolerance of the CPU's on the same pocket."""
    from pharmaconet_tpu_torch import api
    from pharmaconet_tpu_torch.ops import voxelize_cuda
    from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

    small = dict(max_hotspots=8, segmentation_chunk=4, grid_dim=32, _random_init_seed=3,
                 model_kwargs=dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2,
                                   token_feature_dim=16))
    pdb = tmp_path / "pocket.pdb"
    center = write_synthetic_pocket(pdb, seed=0, cavity_radius=3.0, num_atoms=1500,
                                    outer_radius=24.0)["center"]
    widths = dict(token_dim=16, feature_dim=8, num_scales=3)
    proxies = {}
    for device in ("cuda", "cpu"):
        net = api.get_pmnet_dev(device=device, weight_path=None, **small)
        net.focus_threshold = 0.0
        proxy = SBDDReward_Proxy(device=device, model_kwargs=widths)
        proxy._init_random(2)
        proxy.pmnet = net
        proxies[device] = proxy
    net = proxies["cuda"].pmnet
    for fn in (lambda: net.feature_extraction(pdb, center=center),
               lambda: proxies["cuda"].get_cache(pdb, center=center),
               lambda: proxies["cuda"].get_cache(pdb, center=center, fused=False)):
        voxelize_cuda.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == 1
    _assert_cache_close(proxies["cuda"].get_cache(pdb, center=center),
                        proxies["cpu"].get_cache(pdb, center=center))
