"""PharmacoNet on one torch device: protein pocket -> pharmacophore model.

The pipeline of the JAX package's `module.py`, run eagerly:

    parse (host) -> voxelize (K6, csrc/voxelize.cu) -> SwinV2-3D + FPN
    -> cavity/token heads -> relative-score + cavity gating
    -> chunked batched segmentation -> mask/smooth/threshold
    -> sparse density wire -> graph build (host)

Precision is set per stage and restored after it: the trunk and the
cavity/token heads run in full f32 (`matmul_precision`, TF32 off for both
matrix products and cuDNN convolutions), the mask decoder alone in
`segmentation_precision`, whose default 'tensorfloat32' runs the decoder
in float32. The name is the JAX package's default, there three bf16
passes per product that keep the maps at f32's. One TF32 pass, which the
upstream network runs on a GPU (cuDNN's allow_tf32), moves voxels across
the maps' 0.5 threshold on a card (probes/chip_ci.py C6 and chip_smoke.py
phase 7 read how many), so the port departs from it on purpose.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from . import constants as C
from .chem import Protein, load_molecules, load_pdb
from .chem.pocket import extract_pocket_residues
from .data.featurizer import (
    get_protein_pointcloud,
    get_token_and_filter,
    get_token_informations,
)
from .device import resolve_device
from .network.convert import (
    load_npz_checkpoint,
    load_torch_checkpoint,
    random_distributions,
    random_state_dict,
    state_dict_from_flax,
)
from .network.model import build_model
from .ops import voxelize as voxelize_ref
from .ops.postprocess import postprocess_density, sparse_compact
from .ops.voxelize_cuda import voxelize_pallas
from .pharmacophore.model import PharmacophoreModel
from .utils.download_weight import resolve_weight_path

logger = logging.getLogger("pharmaconet_tpu_torch")

ATOM_BUCKETS = (1024, 2048, 4096, 8192)
TOKEN_BUCKETS = (256, 512, 1024, 2048)
PRECISIONS = ("float32", "tensorfloat32", "bfloat16")


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"input size {n} exceeds the largest bucket {buckets[-1]}")


@contextlib.contextmanager
def precision_scope(precision: str, device: torch.device):
    """Float32 products and convolutions at `precision` inside the block;
    the previous flags come back after it. 'float32' turns TF32 off for
    both matrix products and cuDNN, 'tensorfloat32' on, 'bfloat16' runs
    the block under bf16 autocast."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tensorfloat32"
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if precision == "bfloat16":
            with torch.autocast(device.type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


class ProteinData:
    """Padded pocket arrays (numpy, host) + host-side metadata."""

    def __init__(
        self,
        atom_positions: np.ndarray,
        atom_features: np.ndarray,
        atom_valid: np.ndarray,
        tokens: np.ndarray,
        token_valid: np.ndarray,
        token_positions: np.ndarray,
        center: np.ndarray,
        pdbblock: str,
    ):
        self.atom_positions = atom_positions
        self.atom_features = atom_features
        self.atom_valid = atom_valid
        self.tokens = tokens
        self.token_valid = token_valid
        self.token_positions = token_positions  # [T, 3] (unpadded)
        self.center = center
        self.pdbblock = pdbblock


class PharmacoNet:
    """End-to-end pharmacophore modeling on one torch device.

    weight_path: an upstream torch checkpoint (model.tar) or the JAX
    package's .npz. None looks for a checkpoint as the JAX package does
    (`utils/download_weight.resolve_weight_path`: PMNET_TPU_WEIGHT, then
    $PMNET_TPU_HOME/model.{npz,tar}, then the upstream artifact through
    gdown where it is installed) and, finding none, draws the JAX
    package's random parameters (`_random_init_seed`).
    voxelizer: 'kernel' (K6 on CUDA tensors, its plain version on CPU
    tensors) or 'reference' (the plain torch version on any device).
    density_wire: 'sparse' ships each thresholded map to the host as
    (flat index, value) pairs compacted on the device, falling back to a
    dense copy for a map with more than `sparse_transfer_cap` nonzeros;
    'dense' copies every map. Both rebuild bit-identical maps.
    """

    def __init__(
        self,
        weight_path: str | Path | None = None,
        score_threshold: float | dict[str, float] | None = C.DEFAULT_SCORE_THRESHOLD,
        verbose: bool = True,
        max_hotspots: int = C.MAX_HOTSPOTS,
        segmentation_chunk: int = C.SEGMENTATION_CHUNK,
        grid_dim: int = C.GRID_DIM,
        model_kwargs: dict | None = None,
        matmul_precision: str = "float32",
        segmentation_precision: str | None = "tensorfloat32",
        voxelizer: str = "kernel",
        density_wire: str = "sparse",
        sparse_transfer_cap: int = 16384,
        device: str | torch.device = "cuda",
        _random_init_seed: int | None = None,
    ):
        if voxelizer not in ("kernel", "reference"):
            raise ValueError(f"voxelizer {voxelizer!r} is not 'kernel' or 'reference'")
        if density_wire not in ("sparse", "dense"):
            raise ValueError(f"density_wire {density_wire!r} is not 'sparse' or 'dense'")
        self.device = resolve_device(device)
        self.density_wire = density_wire
        self.sparse_transfer_cap = int(sparse_transfer_cap)
        self.voxelizer = voxelizer
        self.matmul_precision = matmul_precision
        self.segmentation_precision = segmentation_precision or matmul_precision
        for p in (self.matmul_precision, self.segmentation_precision):
            if p not in PRECISIONS:
                raise ValueError(f"precision {p!r} is not one of {PRECISIONS}")
        self.grid_dim = grid_dim
        self.max_hotspots = max_hotspots
        self.segmentation_chunk = segmentation_chunk
        self.focus_threshold = C.DEFAULT_FOCUS_THRESHOLD
        self.box_threshold = C.DEFAULT_BOX_THRESHOLD
        self.verbose = verbose
        self._random_init_seed = _random_init_seed

        if isinstance(score_threshold, dict):
            self.score_threshold = score_threshold
        elif isinstance(score_threshold, float):
            self.score_threshold = {t: score_threshold for t in C.INTERACTION_LIST}
        else:
            self.score_threshold = C.DEFAULT_SCORE_THRESHOLD

        self.model = build_model(image_size=grid_dim, **(model_kwargs or {})).eval()
        state, distributions = self._load_weights(weight_path)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).requires_grad_(False)
        self._setup_distributions(distributions)
        self._threshold_vector = torch.tensor(
            [self.score_threshold[t] for t in C.INTERACTION_LIST], dtype=torch.float32,
            device=self.device)
        self._long_types = torch.tensor(sorted(C.LONG_INTERACTION), device=self.device)

    # ------------------------------------------------------------------
    def _load_weights(self, weight_path):
        if weight_path is None:
            # provisioned weights (PMNET_TPU_WEIGHT, $PMNET_TPU_HOME), else a download
            try:
                weight_path = resolve_weight_path(None, self.verbose)
            except (FileNotFoundError, RuntimeError):
                weight_path = None
        if weight_path is None:
            logger.warning("no weights available: using random parameters")
            state = random_state_dict(self.model.config, self._random_init_seed or 0)
            return state, random_distributions()
        weight_path = Path(weight_path)
        if weight_path.suffix == ".npz":
            params, distributions = load_npz_checkpoint(weight_path)
            return state_dict_from_flax(params, self.model.config), distributions
        state, distributions, _ = load_torch_checkpoint(weight_path)
        return state, distributions

    def _setup_distributions(self, distributions: dict[str, np.ndarray]) -> None:
        """Per-type sorted score distributions, padded with +inf, for the
        device searchsorted."""
        self.score_distributions = distributions
        max_len = max(len(d) for d in distributions.values())
        packed = np.full((C.NUM_INTERACTION_TYPES, max_len), np.inf, dtype=np.float32)
        lengths = np.zeros(C.NUM_INTERACTION_TYPES, dtype=np.float32)
        for i, t in enumerate(C.INTERACTION_LIST):
            d = np.sort(np.asarray(distributions[t], dtype=np.float32))
            packed[i, : len(d)] = d
            lengths[i] = len(d)
        self._dist_packed = torch.from_numpy(packed).to(self.device)
        self._dist_lengths = torch.from_numpy(lengths).to(self.device)

    # ------------------------------------------------------------------
    # Host parsing (input pipeline)
    # ------------------------------------------------------------------
    @staticmethod
    def get_center(
        ref_ligand_path: str | Path | None = None,
        center: tuple[float, float, float] | np.ndarray | None = None,
    ) -> tuple[float, float, float]:
        if center is not None:
            assert len(center) == 3
            return (float(center[0]), float(center[1]), float(center[2]))
        assert ref_ligand_path is not None
        mol = load_molecules(ref_ligand_path, max_mols=1)[0].strip_hydrogens()
        c = mol.coords.mean(axis=0)
        return (float(c[0]), float(c[1]), float(c[2]))

    def parse(
        self,
        protein_pdb_path: str | Path,
        ref_ligand_path: str | Path | None = None,
        center=None,
        pocket_extract: bool = True,
        center_noise: float = 0.0,
    ) -> ProteinData:
        center = np.asarray(self.get_center(ref_ligand_path, center), dtype=np.float32)
        if center_noise > 0:
            center = center + (np.random.rand(3).astype(np.float32) * 2 - 1) * center_noise
        residues = load_pdb(protein_pdb_path)
        pocket = extract_pocket_residues(residues, center) if pocket_extract else residues
        protein = Protein.from_residues(pocket)

        token_positions, token_classes = get_token_informations(protein)
        tokens, keep = get_token_and_filter(
            token_positions, token_classes, center, dimension=self.grid_dim
        )
        token_positions = token_positions[keep]

        atom_positions, atom_features = get_protein_pointcloud(protein)

        num_atoms = len(atom_positions)
        pad_atoms = _bucket(num_atoms, ATOM_BUCKETS)
        ap = np.zeros((pad_atoms, 3), dtype=np.float32)
        af = np.zeros((pad_atoms, C.NUM_PROTEIN_CHANNELS), dtype=np.float32)
        av = np.zeros((pad_atoms,), dtype=bool)
        ap[:num_atoms], af[:num_atoms], av[:num_atoms] = atom_positions, atom_features, True

        num_tokens = len(tokens)
        pad_tokens = _bucket(max(num_tokens, 1), TOKEN_BUCKETS)
        tk = np.zeros((pad_tokens, 4), dtype=np.int32)
        tv = np.zeros((pad_tokens,), dtype=bool)
        tk[:num_tokens] = tokens.astype(np.int32)
        tv[:num_tokens] = True

        with open(protein_pdb_path) as f:
            pdbblock = f.read()
        return ProteinData(ap, af, av, tk, tv, token_positions, center, pdbblock)

    # ------------------------------------------------------------------
    # Device stages
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def voxelize(self, data: ProteinData) -> tuple[torch.Tensor, torch.Tensor]:
        """([D,H,W,33] image, [D,H,W] occupancy) of the pocket's atoms."""
        args = (self._tensor(data.atom_positions), self._tensor(data.atom_features),
                self._tensor(data.atom_valid), self._tensor(data.center))
        fn = voxelize_pallas if self.voxelizer == "kernel" else voxelize_ref.voxelize
        return fn(*args, dim=self.grid_dim)

    @torch.no_grad()
    def trunk(self, image: torch.Tensor) -> list[torch.Tensor]:
        """SwinV2-3D + FPN in `matmul_precision`: the top-down pyramid, NDHWC."""
        with precision_scope(self.matmul_precision, self.device):
            return self.model.forward_feature(image[None])

    @torch.no_grad()
    def heads(self, data: ProteinData, pyramid: list[torch.Tensor],
              occupancy: torch.Tensor) -> dict[str, Any]:
        """Cavity and token heads in `matmul_precision`, then the relative
        scores and the gating: the trunk outputs segmentation consumes."""
        tokens = self._tensor(data.tokens)
        token_valid = self._tensor(data.token_valid)
        with precision_scope(self.matmul_precision, self.device):
            narrow_logit, wide_logit = self.model.forward_cavity_extraction(pyramid[-1])
            token_logits, token_features = self.model.forward_token_prediction(
                pyramid[-1], tokens)
        cavity_narrow = torch.sigmoid(narrow_logit[0, ..., 0]) > self.focus_threshold
        cavity_wide = torch.sigmoid(wide_logit[0, ..., 0]) > self.focus_threshold
        abs_scores = torch.sigmoid(token_logits)

        # relative scores: mean(dist[type] < score), searchsorted side 'left'
        types = tokens[:, 3].long()
        counts = torch.searchsorted(self._dist_packed[types], abs_scores[:, None].contiguous(),
                                    right=False)[:, 0]
        rel_scores = counts.to(torch.float32) / self._dist_lengths[types]

        x, y, z = tokens[:, 0].long(), tokens[:, 1].long(), tokens[:, 2].long()
        cavity = torch.where(torch.isin(types, self._long_types),
                             cavity_wide[x, y, z], cavity_narrow[x, y, z])
        keep = token_valid & cavity & (rel_scores >= self._threshold_vector[types])
        return {
            "pyramid": pyramid,
            "protein_mask": ~occupancy,  # True = empty space
            "cavity_narrow": cavity_narrow,
            "cavity_wide": cavity_wide,
            "abs_scores": abs_scores,
            "rel_scores": rel_scores,
            "keep": keep,
            "token_features": token_features,
        }

    def run_trunk(self, data: ProteinData) -> dict[str, Any]:
        """Voxelize + SwinV2 + FPN + cavity/token heads for one parsed
        pocket (no segmentation); device tensors."""
        image, occupancy = self.voxelize(data)
        return self.heads(data, self.trunk(image), occupancy)

    @torch.no_grad()
    def segment_logits(self, out: dict[str, Any], hot_tokens: torch.Tensor,
                       hot_features: torch.Tensor) -> torch.Tensor:
        """Mask decoder in `segmentation_precision`, 'tensorfloat32' run as
        float32 (module docstring): [K, D, H, W] f32 logits."""
        precision = self.segmentation_precision
        with precision_scope("float32" if precision == "tensorfloat32" else precision,
                             self.device):
            logits = self.model.forward_segmentation(out["pyramid"], hot_tokens, hot_features)
        return logits.float()

    @torch.no_grad()
    def postprocess(self, out: dict[str, Any], hot_tokens: torch.Tensor, logits: torch.Tensor,
                    valid: np.ndarray):
        """Mask, smooth and threshold one chunk's maps (padding slots are
        zeroed). Returns (density [K,D,H,W], sparse) with sparse
        (vals, idxs, counts) compacted on the device on the sparse wire,
        else None."""
        density = postprocess_density(logits, hot_tokens, out["protein_mask"],
                                      out["cavity_narrow"], self.box_threshold)
        density = torch.where(self._tensor(valid)[:, None, None, None], density, 0.0)
        if self.density_wire == "sparse":
            return density, sparse_compact(density, self.sparse_transfer_cap)
        return density, None

    def segment(self, out: dict[str, Any], tokens: torch.Tensor, idx: np.ndarray,
                valid: np.ndarray):
        """Segmentation of the hotspot tokens `idx` (a padded chunk; `valid`
        marks the real ones): `segment_logits` then `postprocess`."""
        idx_dev = self._tensor(idx).long()
        hot_tokens = tokens[idx_dev]
        logits = self.segment_logits(out, hot_tokens, out["token_features"][idx_dev])
        return self.postprocess(out, hot_tokens, logits, valid)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def run(
        self,
        protein_pdb_path: str | Path,
        ref_ligand_path: str | Path | None = None,
        center=None,
    ) -> PharmacophoreModel:
        assert (ref_ligand_path is not None) or (center is not None)
        data = self.parse(protein_pdb_path, ref_ligand_path, center)
        hotspot_infos = self.create_density_maps(data)
        return PharmacophoreModel.create(
            data.pdbblock, data.center, hotspot_infos, size=self.grid_dim
        )

    def create_density_maps(self, data: ProteinData) -> list[dict[str, Any]]:
        """Trunk once, then segment exactly the kept tokens, in token index
        order, in chunks of `segmentation_chunk`."""
        out = self.run_trunk(data)
        keep_idx = np.nonzero(out["keep"].cpu().numpy())[0]
        if self.verbose:
            logger.info("pocket keeps %d hotspots: %d chunk(s) of %d", len(keep_idx),
                        -(-len(keep_idx) // self.segmentation_chunk), self.segmentation_chunk)
        return self._segment_kept(data, out, keep_idx)

    def _segment_kept(
        self, data: ProteinData, out: dict[str, Any], keep_idx: np.ndarray
    ) -> list[dict[str, Any]]:
        """Segment the given token indices in padded chunks of
        `segmentation_chunk`, reusing the pocket's pyramid on the device;
        returns hotspot infos. (The JAX package also runs whole
        `max_hotspots` slabs to bound recompiles; an eager run needs none,
        and the maps do not depend on the split.)"""
        chunk = self.segmentation_chunk
        rel_scores = out["rel_scores"].cpu().numpy()
        tokens = self._tensor(data.tokens)
        infos: list[dict[str, Any]] = []
        for start in range(0, len(keep_idx), chunk):
            part = keep_idx[start : start + chunk]
            idx = np.zeros(chunk, dtype=np.int64)
            idx[: len(part)] = part
            valid = np.zeros(chunk, dtype=bool)
            valid[: len(part)] = True
            density, sparse = self.segment(out, tokens, idx, valid)
            infos += self.hotspot_infos_from_outputs(data, idx, valid, rel_scores, density,
                                                     sparse=sparse)
        return infos

    def hotspot_infos_from_outputs(
        self,
        data: ProteinData,
        hotspot_idx: np.ndarray,
        hotspot_valid: np.ndarray,
        rel_scores: np.ndarray,
        density_maps: torch.Tensor,
        sparse: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    ) -> list[dict[str, Any]]:
        """Host post-processing of one chunk's device outputs. On the sparse
        wire the maps are rebuilt by an exact scatter; a map whose count
        overflows the cap is copied densely."""
        valid_slots = np.nonzero(hotspot_valid)[0]
        map_shape = tuple(density_maps.shape[1:])
        if sparse is not None:
            vals_dev, idxs_dev, counts_dev = sparse
            counts_h = counts_dev.cpu().numpy()
            cap = vals_dev.shape[1]
            if len(valid_slots):
                # copy only the used prefix of the cap axis (overflowing maps
                # go dense), rounded up to 256
                cs = counts_h[valid_slots]
                used = int(cs[cs <= cap].max()) if (cs <= cap).any() else 0
                w = min(cap, max(256, -(-used // 256) * 256))
                vs = self._tensor(valid_slots).long()
                vals_h = vals_dev[vs, :w].cpu().numpy()
                idxs_h = idxs_dev[vs, :w].cpu().numpy()
        elif len(valid_slots):
            density_valid = density_maps[self._tensor(valid_slots).long()].cpu().numpy()

        hotspot_infos = []
        for k, slot in enumerate(valid_slots):
            if sparse is not None:
                c = int(counts_h[slot])
                if c > cap:  # overflow: dense copy of this one map
                    dmap = density_maps[int(slot)].cpu().numpy()
                else:
                    dmap = np.zeros(int(np.prod(map_shape)), np.float32)
                    dmap[idxs_h[k, :c]] = vals_h[k, :c]
                    dmap = dmap.reshape(map_shape)
            else:
                dmap = density_valid[k]
            if np.all(dmap < 1e-6):
                continue
            token_i = int(hotspot_idx[slot])
            interaction_type = C.INTERACTION_LIST[int(data.tokens[token_i, 3])]
            hotspot_infos.append(
                {
                    "nci_type": interaction_type,
                    "hotspot_type": C.INTERACTION_TO_HOTSPOT[interaction_type],
                    "hotspot_position": tuple(
                        float(v) for v in data.token_positions[token_i]
                    ),
                    "hotspot_score": float(rel_scores[token_i]),
                    "point_type": C.INTERACTION_TO_PHARMACOPHORE[interaction_type],
                    "point_map": dmap,
                }
            )
        if self.verbose:
            logger.info("detected %d hotspots", len(hotspot_infos))
        return hotspot_infos

    def feature_extraction(
        self,
        protein_pdb_path: str | Path,
        ref_ligand_path: str | Path | None = None,
        center=None,
    ) -> tuple[list[np.ndarray], list[dict[str, Any]]]:
        data = self.parse(protein_pdb_path, ref_ligand_path, center)
        return self.run_extraction(data)

    def run_extraction(self, data: ProteinData) -> tuple[list[np.ndarray], list[dict[str, Any]]]:
        """Pocket multi-scale features (NDHWC, as the JAX package) + hotspot
        features."""
        out = self.run_trunk(data)
        keep = out["keep"].cpu().numpy()
        rel_scores = out["rel_scores"].cpu().numpy()
        token_features = out["token_features"].cpu().numpy()

        hotspot_infos = []
        for i in np.nonzero(keep)[0]:
            interaction_type = C.INTERACTION_LIST[int(data.tokens[i, 3])]
            hotspot_infos.append(
                {
                    "nci_type": interaction_type,
                    "hotspot_type": C.INTERACTION_TO_HOTSPOT[interaction_type],
                    "hotspot_feature": token_features[i],
                    "hotspot_position": tuple(float(v) for v in data.token_positions[i]),
                    "hotspot_score": float(rel_scores[i]),
                    "point_type": C.INTERACTION_TO_PHARMACOPHORE[interaction_type],
                }
            )
        multi_scale_features = [p.contiguous().cpu().numpy() for p in out["pyramid"]]
        return multi_scale_features, hotspot_infos
