"""Concrete docking proxies + registry.

Upstream pmnet_appl/__init__.py:26-70 (get_docking_proxy),
tacogfn_reward/proxy.py:39-105 and sbddreward/proxy.py:35-144, as
`pharmaconet_tpu`'s `proxy/proxies.py` has them, on one torch device.
Caches are host tuples of numpy arrays (and floats), as in the JAX
package; scoring featurizes on the host (`smi2graph_list`, one C++ call)
and `BaseProxy._score_graphs` pads, copies and scores the batch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .base import BaseProxy, Cache
from .data import smi2graph_list
from .sbddreward import SBDDRewardNetwork, convert_sbddreward_checkpoint
from .tacogfn import TacoAffinityHead, convert_tacogfn_checkpoint


def _load_torch_state(ckpt_path: str | Path, key: str | None = None) -> dict:
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if key is not None and isinstance(ckpt, dict) and key in ckpt:
        ckpt = ckpt[key]
    return ckpt


class TacoGFN_Proxy(BaseProxy):
    """Cache = (pocket vector [256], hotspot features [K, 256])."""

    cache_gdrive_link = {
        ("QVina-ZINCDock15M", "train"): "1VibvAjhir5oXx5cmzfE0F2UVTSDsGH3v",
        ("QVina-ZINCDock15M", "test"): "1F05JjkJuc6FwU4h8MLUEan34ovewGPLz",
        ("QVina-CrossDocked2020", "train"): "1-5he-ItdtcZvlGqyI_rVU0XIk0XGzFC-",
        ("QVina-CrossDocked2020", "test"): "1Ps3-Mj2GHH_FLtnjAD1riYiRyK01C_T8",
    }
    model_gdrive_link = {
        "QVina-ZINCDock15M": "1lrH79-6YI2CfEP5sWIWzgboZsONXWkIZ",
        "QVina-CrossDocked2020": "1Kjn4xNc8458Ibf-ckWjtuUotuhGFLiHK",
    }
    categorical = True
    invalid_smiles = "raise"  # an unparseable SMILES raises ValueError

    def _build_model(self):
        return TacoAffinityHead(**self._model_kwargs)

    def _load_checkpoint(self, ckpt_path):
        self.load_state_dict(convert_tacogfn_checkpoint(_load_torch_state(ckpt_path, "model")))

    def _pocket_cache(self, pyramid, hotspot_features, hotspot_positions) -> Cache:
        del hotspot_positions  # TacoGFN caches carry no positions
        pocket, token = self.model.ready_to_calculate(pyramid, hotspot_features)
        return (pocket.cpu().numpy(), token.cpu().numpy())

    def _scoring_list(self, cache: Cache, smiles_list: list[str]) -> np.ndarray:
        maybe = smi2graph_list(smiles_list)
        if any(g is None for g in maybe):
            bad = next(i for i, g in enumerate(maybe) if g is None)
            raise ValueError(f"unparseable SMILES: {smiles_list[bad]!r}")
        return self._score_graphs(cache, maybe, [True] * len(maybe))

    def _forward_inputs(self, cache, arrays) -> tuple:
        pocket, token = cache
        return self._tensor(pocket), self._tensor(token), arrays

    @classmethod
    def load(cls, docking: str, train_dataset: str, db, device="cuda"):
        assert docking in ("QVina", "QuickVina")
        assert train_dataset in ("ZINCDock15M", "CrossDocked2020")
        return super().load("QVina", train_dataset, db, device)


class SBDDReward_Proxy(BaseProxy):
    """Cache = (hotspot X [K,128], positions [K,3], pocket Z [128], mu, std)."""

    cache_gdrive_link = {
        ("UniDock_Vina-ZINC", "train"): "",
        ("UniDock_Vina-ZINC", "test"): "",
    }
    model_gdrive_link = {"UniDock_Vina-ZINC": ""}
    categorical = False
    invalid_smiles = "zero"  # an unparseable SMILES scores 0.0

    def _build_model(self):
        return SBDDRewardNetwork(**self._model_kwargs)

    def _load_checkpoint(self, ckpt_path):
        self.load_state_dict(convert_sbddreward_checkpoint(_load_torch_state(ckpt_path)))

    def _pocket_cache(self, pyramid, hotspot_features, hotspot_positions) -> Cache:
        x, _, z, mu, std = self.model.get_cache(pyramid, hotspot_features, None)
        return (x.cpu().numpy(), hotspot_positions, z.cpu().numpy(), float(mu), float(std))

    def _scoring_list(self, cache: Cache, smiles_list: list[str],
                      return_sigma: bool = False) -> np.ndarray:
        # an invalid SMILES scores 0.0 (sbddreward/proxy.py:54-72)
        maybe = smi2graph_list(smiles_list)
        flags = [g is not None for g in maybe]
        if not any(flags):
            return np.zeros(len(smiles_list), dtype=np.float32)
        return self._score_graphs(cache, [g for g in maybe if g is not None], flags,
                                  return_sigma=return_sigma)

    def _forward_inputs(self, cache, arrays, return_sigma: bool = False) -> tuple:
        dev_cache = (*(self._tensor(a) for a in cache[:3]), float(cache[3]), float(cache[4]))
        return dev_cache, arrays, return_sigma

    def scoring(self, target, smiles, return_sigma: bool = False):
        return self._scoring_list(self._cache[target], [smiles], return_sigma)

    def scoring_list(self, target, smiles_list, return_sigma: bool = False):
        return self._scoring_list(self._cache[target], smiles_list, return_sigma)

    def get_statistic(self, target: str) -> tuple[float, float]:
        cache = self._cache[target]
        return cache[-2], cache[-1]

    @classmethod
    def load(cls, docking: str, train_dataset: str, db, device="cuda"):
        assert docking in ("UniDock_Vina",)
        assert train_dataset in ("ZINC",)
        return super().load(docking, train_dataset, db, device)


def get_docking_proxy(model: str, docking: str, train_dataset: str, db: str | Path | None,
                      device: str | torch.device = "cuda") -> BaseProxy:
    """Proxy registry (pmnet_appl/__init__.py:26-70).

    model: 'TacoGFN_Reward' | 'SBDDReward'
    docking: 'QVina' | 'UniDock_Vina'
    train_dataset: 'ZINCDock15M' | 'CrossDocked2020' | 'ZINC'
    db: 'train' | 'test' | 'all' | custom cache path | None
    """
    if model == "TacoGFN_Reward":
        return TacoGFN_Proxy.load(docking, train_dataset, db, device)
    if model == "SBDDReward":
        return SBDDReward_Proxy.load(docking, train_dataset, db, device)
    raise ValueError(f"unknown proxy model: {model}")
