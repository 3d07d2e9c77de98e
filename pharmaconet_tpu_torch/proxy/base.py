"""Docking-proxy base: target-cache protocol + SMILES scoring on one device.

Upstream base/proxy.py:32-278, as `pharmaconet_tpu`'s `proxy/base.py`
has it: lazy PharmacoNet setup, per-target pocket caches, scoring and
scoring_list over SMILES, cache-database construction that tolerates a
failure per pocket, and the pretrained artifacts. Artifacts are looked up
locally only (`$PMNET_TPU_HOME/proxies/<class>/`): a missing one raises
`RuntimeError` naming its path and Google Drive id; nothing is fetched.

Precision: the cache path (`get_cache`, `_get_cache`) runs in full f32 —
TF32 off for matrix products and cuDNN convolutions, as the JAX cache path
pins float32 — and scoring in the proxy's `precision`.
"""

from __future__ import annotations

import contextlib
import pickle
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..module import precision_scope
from ..utils.download_weight import default_weight_dir
from .data import batch_graphs, half_octave
from .tacogfn import TOKEN_DIM, graph_batch_to_arrays

Cache = Any
PRECISIONS = ("float32", "tensorfloat32", "bfloat16")

_KEYS_DIR = Path(__file__).parent / "keys"


def load_cache_keys(dataset: str, variant: str = "base") -> list[str]:
    """CrossDocked2020 pocket keys of the pretrained cache databases:
    upstream `pmnet_appl/keys/{train,test}.txt` (15,201 / 100 pockets) and
    the TacoGFN variant `tacogfn_reward/db_keys/{train,test}.txt` (15,207 /
    100), the keys of the 'train'/'test' databases `BaseProxy.load` takes."""
    if dataset not in ("train", "test"):
        raise ValueError(f"dataset must be 'train' or 'test', got {dataset!r}")
    sub = {"base": _KEYS_DIR, "tacogfn": _KEYS_DIR / "tacogfn"}[variant]
    return (sub / f"{dataset}.txt").read_text().split()


@contextlib.contextmanager
def proxy_scope(precision: str, device: torch.device):
    """Full f32 products and convolutions ('float32' and 'bfloat16': a
    bfloat16 proxy casts its tensors itself, it is no autocast) or TF32
    ('tensorfloat32') inside the block; the flags come back after it."""
    with precision_scope("tensorfloat32" if precision == "tensorfloat32" else "float32",
                         device):
        yield


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a (nested) tuple/list/dict cast to dtype;
    indices and Python numbers pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floating(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree


class BaseProxy:
    cache_gdrive_link: dict[tuple[str, str], str] = {}
    model_gdrive_link: dict[str, str] = {}
    categorical = True  # ligand graph inputs: atom/bond classes, else one-hot features

    def __init__(self, ckpt_path: str | Path | None = None, pmnet_kwargs: dict | None = None,
                 precision: str = "float32", device: str | torch.device = "cuda",
                 model_kwargs: dict | None = None):
        """precision of scoring: 'float32' (default; upstream's linears are
        true f32), 'tensorfloat32' (TF32 products), or 'bfloat16' (the
        parameters and every floating activation cast to bf16, scores
        returned as float32; the JAX package's compute-dtype opt-in).
        model_kwargs set the network's input widths for a PharmacoNet of
        another configuration (`token_dim`, `feature_dim`, `num_scales`); the published
        widths by default."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
        self.device = resolve_device(device)
        self.pmnet = None  # lazy (base/proxy.py:44, 269-274)
        self._cache: dict[str, Cache] = {}
        self._pmnet_kwargs = pmnet_kwargs or {}
        self._model_kwargs = model_kwargs or {}
        self.precision = precision
        self.model = self._build_model().to(self.device).eval().requires_grad_(False)
        if ckpt_path is not None:
            self._load_checkpoint(ckpt_path)

    # -- implement in subclasses ---------------------------------------
    def _build_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def _load_checkpoint(self, ckpt_path: str | Path):
        raise NotImplementedError

    def _pocket_cache(self, pyramid: list[torch.Tensor], hotspot_features: torch.Tensor,
                      hotspot_positions: np.ndarray) -> Cache:
        """The cache from the top-down channel-last pyramid and the kept
        hotspots' features [K, token_dim] (device tensors) and positions
        [K, 3] (host)."""
        raise NotImplementedError

    def _scoring_list(self, cache: Cache, smiles_list: list[str]) -> np.ndarray:
        raise NotImplementedError

    def _forward_inputs(self, cache: Cache, arrays: tuple, **kw) -> tuple:
        """The model forward's arguments: the cache on the device + arrays."""
        raise NotImplementedError

    # -- parameters -----------------------------------------------------
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(state, strict=True)

    def _init_random(self, seed: int = 0) -> None:
        """Reproducible random parameters at the published widths."""
        from .convert import random_state_dict

        self.load_state_dict(random_state_dict(self.model, seed))

    def _forward(self, *args):
        """The model's scoring forward in `precision`: bfloat16 runs it on
        bf16 copies of the parameters and floating inputs and returns
        float32."""
        with torch.no_grad(), proxy_scope(self.precision, self.device):
            if self.precision != "bfloat16":
                return self.model(*args)
            params = {k: cast_floating(v, torch.bfloat16)
                      for k, v in self.model.state_dict(keep_vars=True).items()}
            out = torch.func.functional_call(self.model, params,
                                             cast_floating(args, torch.bfloat16))
            return out.float()

    def _score_graphs(self, cache: Cache, graphs: list, flags: list[bool], **kw) -> np.ndarray:
        """Scores of featurized graphs, padded to `half_octave` graphs as in
        the JAX package and copied to the device; `flags` marks which inputs
        they are (the others score 0.0)."""
        batch = batch_graphs(graphs, num_graphs_pad=half_octave(len(graphs)))
        arrays = graph_batch_to_arrays(batch, self.categorical, device=self.device)
        scores = self._forward(*self._forward_inputs(cache, arrays, **kw))
        scores = scores.cpu().numpy()[: len(graphs)]
        if all(flags):
            return scores
        result = np.zeros(len(flags), dtype=np.float32)
        result[np.asarray(flags)] = scores
        return result

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- weight management ----------------------------------------------
    @classmethod
    def _weight_dir(cls) -> Path:
        return default_weight_dir() / "proxies" / cls.__name__

    @classmethod
    def _local_artifact(cls, gdrive_id: str, path: Path) -> Path:
        """`path` if it is provisioned; raises naming it otherwise (where
        the JAX package would fetch it with gdown)."""
        if not path.exists():
            raise RuntimeError(
                f"proxy artifact {path.name} is not available locally and this package "
                f"downloads nothing: provision it at {path} (Google Drive id: "
                f"{gdrive_id or 'not published'})")
        return path

    @classmethod
    def load(cls, docking: str, train_dataset: str, db: str | Path | None,
             device: str | torch.device = "cuda") -> "BaseProxy":
        """A pretrained proxy + optional CrossDocked2020 cache database
        ('train' 15,201 pockets | 'test' 100 | 'all' | custom path)."""
        device = resolve_device(device)
        weight_dir = cls._weight_dir()
        suffix = f"{docking}-{train_dataset}"
        ckpt_path = cls._local_artifact(cls.model_gdrive_link[suffix],
                                        weight_dir / f"model-{suffix}.pth")
        cache_dict: dict[str, Cache] = {}
        labels = {"train": ["train"], "test": ["test"], "all": ["train", "test"]}.get(db)
        if labels is not None:
            for label in labels:
                cache_path = cls._local_artifact(cls.cache_gdrive_link[(suffix, label)],
                                                 weight_dir / f"cache-{label}-{suffix}.pt")
                cache_dict.update(cls._load_cache_file(cache_path))
        elif db is not None:
            cache_dict.update(cls._load_cache_file(db))
        proxy = cls(ckpt_path, device=device)
        proxy.update_cache(cache_dict)
        return proxy

    @staticmethod
    def _load_cache_file(path: str | Path) -> dict[str, Cache]:
        """A cache database: upstream's torch file (`torch.save` of
        {key: tuple of tensors}) or a pickle of numpy tuples, as
        `_save_cache_file` and the JAX package's `_save_cache_file` write.
        Caches come back as tuples of numpy arrays and numbers."""
        try:
            raw = torch.load(path, map_location="cpu", weights_only=False)
        except (RuntimeError, pickle.UnpicklingError):  # not a torch file
            with open(path, "rb") as f:
                raw = pickle.load(f)
        return {
            key: tuple(v.numpy() if isinstance(v, torch.Tensor) else v for v in value)
            for key, value in raw.items()
        }

    @staticmethod
    def _save_cache_file(cache_dict: dict[str, Cache], path: str | Path) -> None:
        with open(path, "wb") as w:
            pickle.dump(cache_dict, w)

    # -- cache protocol ---------------------------------------------------
    def put_cache(self, key: str, cache: Cache) -> None:
        self._cache[key] = cache

    def update_cache(self, cache_dict: dict[str, Cache]) -> None:
        self._cache.update(cache_dict)

    def _get_cache(self, multi_scale_features, hotspot_infos) -> Cache:
        """The cache from `feature_extraction`'s outputs (host arrays)."""
        if hotspot_infos:
            features = np.stack([np.asarray(i["hotspot_feature"], np.float32)
                                 for i in hotspot_infos])
            positions = np.array([i["hotspot_position"] for i in hotspot_infos], np.float32)
        else:
            features = np.zeros((0, self._model_kwargs.get("token_dim", TOKEN_DIM)), np.float32)
            positions = np.zeros((0, 3), np.float32)
        with torch.no_grad(), proxy_scope("float32", self.device):
            return self._pocket_cache([self._tensor(f) for f in multi_scale_features],
                                      self._tensor(features), positions)

    def get_cache(self, protein_pdb_path: str | Path, ref_ligand_path: str | Path | None = None,
                  center=None, fused: bool = True) -> Cache:
        """Target cache for one pocket (base/proxy.py:190-205).

        fused=True (default) keeps the PharmacoNet trunk outputs on the
        device and runs the pocket encoder on them: the ~100 MB pyramid never
        crosses to the host, and the kept token rows are gathered on the
        device. fused=False is the two-step path (`feature_extraction` to
        host numpy, then `_get_cache`). Both run the same pocket encoder on
        the same values (equal caches, tested); each launches the voxelizer
        K6 once."""
        self.setup_pmnet()
        if not fused:
            features, hotspot_infos = self.pmnet.feature_extraction(
                protein_pdb_path, ref_ligand_path, center)
            return self._get_cache(features, hotspot_infos)

        data = self.pmnet.parse(protein_pdb_path, ref_ligand_path, center)
        return self._cache_from_trunk(data, self.pmnet.run_trunk(data))

    def _cache_from_trunk(self, data, out: dict) -> Cache:
        """The cache from one parsed pocket's `run_trunk` outputs (on this
        proxy's device): the kept token rows gathered on the device, their
        positions taken on the host."""
        keep = out["keep"]
        positions = np.asarray(data.token_positions, np.float32)[
            np.nonzero(keep.cpu().numpy())[0]]
        with torch.no_grad(), proxy_scope("float32", self.device):
            return self._pocket_cache(out["pyramid"], out["token_features"][keep], positions)

    def get_cache_database(self, pocket_info: dict[str, tuple],
                           save_path: str | Path | None = None,
                           verbose: bool = True) -> dict[str, Cache]:
        """One cache per pocket {key: (protein pdb, centre or ligand path)};
        a pocket that fails is printed and skipped (base/proxy.py:223-236)."""
        import tqdm

        cache_dict: dict[str, Cache] = {}
        for key, (protein_pdb_path, pocket_center) in tqdm.tqdm(
                pocket_info.items(), disable=not verbose):
            try:
                if isinstance(pocket_center, (str, Path)):
                    cache = self.get_cache(protein_pdb_path, ref_ligand_path=pocket_center)
                else:
                    cache = self.get_cache(protein_pdb_path, center=pocket_center)
            except Exception as e:  # noqa: BLE001 - tolerant batch building
                print(key, e)
            else:
                cache_dict[key] = cache
        if save_path is not None:
            self._save_cache_file(cache_dict, save_path)
        return cache_dict

    def setup_pmnet(self) -> None:
        if self.pmnet is None:
            from ..api import get_pmnet_dev

            self.pmnet = get_pmnet_dev(**{"device": self.device, **self._pmnet_kwargs})

    # -- scoring ---------------------------------------------------------
    def scoring(self, target: str, smiles: str) -> np.ndarray:
        """Estimated docking score for one SMILES against a cached target."""
        return self._scoring_list(self._cache[target], [smiles])

    def scoring_list(self, target: str, smiles_list: list[str]) -> np.ndarray:
        """Estimated docking scores [N] for SMILES against a cached target."""
        return self._scoring_list(self._cache[target], smiles_list)
