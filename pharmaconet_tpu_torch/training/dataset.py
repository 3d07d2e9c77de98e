"""Per-pocket training dataset (developer/src/dataset.py:14-55 equivalent).

Each item is the frozen PharmacoNet trunk's output on one pocket (with
centre-noise augmentation) and its padded ligand graph batch with capped
affinities, as `pharmaconet_tpu/training/dataset.py` builds it. The ligand
pickle maps pocket code -> [(ligand_id, smiles, affinity)].

The 5-level pyramid stays on the trunk's device (about 115 MB per pocket
in float32 at the published widths, 100.7 MB of it the 64^3 x 96 level):
`run_trunk`'s tensors are kept, with no round trip through
`run_extraction`'s host copy. The kept token rows are gathered on the
device; the small arrays (hotspots, graphs, affinities) are host numpy,
equal to the JAX dataset's, and go to the device per step.
"""

from __future__ import annotations

import logging
import pickle
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..proxy.data import batch_graphs, half_octave, smi2graph

logger = logging.getLogger("pharmaconet_tpu_torch")


def device_arrays(arrays: tuple, device) -> tuple:
    """A graph-array tuple (7 numpy arrays + num_graphs) as tensors on
    `device`: indices int64, features float32, masks bool."""
    *arrs, num_graphs = arrays

    def dev(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, torch.int64 if a.dtype.kind in "iu" else None)

    return (*(dev(np.asarray(a)) for a in arrs), int(num_graphs))


@dataclass
class PocketItem:
    """One pocket's training inputs. The ragged axes arrive bucketed (the
    hotspot count and the ligand graph batch pad to half-octave buckets,
    masked exactly downstream)."""

    multi_scale_features: list  # top-down pyramid, [1, d, d, d, C] tensors on the device
    hotspot_features: np.ndarray  # [Kpad, token_dim]
    hotspot_positions: np.ndarray  # [Kpad, 3]
    hotspot_valid: np.ndarray  # [Kpad] bool
    batch_arrays: tuple  # 7 numpy arrays (dense atom and bond features) + num_graphs
    affinities: np.ndarray  # [NGpad]
    ligand_valid: np.ndarray  # [NGpad]

    def model_args(self, device) -> tuple:
        """DevAffinityModel's arguments on `device`."""
        return (
            [f.to(device) for f in self.multi_scale_features],
            torch.from_numpy(self.hotspot_features).to(device),
            torch.from_numpy(self.hotspot_positions).to(device),
            device_arrays(self.batch_arrays, device),
            torch.from_numpy(self.hotspot_valid).to(device),
        )

    def loss_args(self, device) -> tuple:
        """DevAffinityModel.loss's arguments on `device`."""
        feats, hf, hp, ba, hv = self.model_args(device)
        return (feats, hf, hp, ba, torch.from_numpy(self.affinities).to(device),
                torch.from_numpy(self.ligand_valid).to(device), hv)


class PocketLigandDataset:
    """Pockets of `code_list` with their ligands, through `pmnet` (on its
    device). `timings` gets one record per item fetched: host seconds of
    the parse, of the trunk (K6, SwinV2-3D + FPN, heads, the kept rows to
    the host) and of the ligand featurization."""

    def __init__(
        self,
        code_list: list[str],
        protein_info: dict[str, tuple[float, float, float]],
        protein_dir: str | Path,
        ligand_path: str | Path,
        pmnet,
        center_noise: float = 0.0,
    ):
        self.code_list = code_list
        self.protein_info = protein_info
        self.protein_dir = Path(protein_dir)
        self.center_noise = center_noise
        self.pmnet = pmnet
        self.timings: list[dict[str, float]] = []
        with open(ligand_path, "rb") as f:
            self.ligand_data: dict[str, list[tuple[str, str, float]]] = pickle.load(f)

    def __len__(self) -> int:
        return len(self.code_list)

    def skip(self, index: int) -> None:
        """The host draws item `index` makes, without the item: with centre
        noise, `PharmacoNet.parse` draws three numbers of numpy's global
        generator."""
        if self.center_noise > 0:
            np.random.rand(3)

    def __getitem__(self, index: int) -> PocketItem:
        code = self.code_list[index]
        t0 = time.perf_counter()
        data = self.pmnet.parse(str(self.protein_dir / f"{code}.pdb"),
                                center=self.protein_info[code], center_noise=self.center_noise)
        t1 = time.perf_counter()
        out = self.pmnet.run_trunk(data)
        keep_idx = np.nonzero(out["keep"].cpu().numpy())[0]
        hotspot_features = out["token_features"][out["keep"]].cpu().numpy()
        hotspot_positions = np.asarray(data.token_positions, np.float32)[keep_idx]
        t2 = time.perf_counter()
        k = len(keep_idx)
        if k == 0:
            # a hotspot-less pocket makes the interaction-sum head predict
            # exactly 0 for every ligand: a constant, zero-gradient loss term
            logger.warning("pocket %s produced no hotspots; its loss term has zero "
                           "gradient (check weights / thresholds)", code)

        # bucket the hotspot axis (exactly masked via hotspot_valid)
        k_pad = half_octave(max(k, 1))
        hf = np.zeros((k_pad, hotspot_features.shape[1]), dtype=np.float32)
        hp = np.zeros((k_pad, 3), dtype=np.float32)
        hv = np.zeros(k_pad, dtype=bool)
        hf[:k], hp[:k], hv[:k] = hotspot_features, hotspot_positions, True

        ligands = self.ligand_data[code]
        graphs = [smi2graph(smiles) for _, smiles, _ in ligands]
        affinities = [min(float(a), 0.0) for _, _, a in ligands]  # cap (dataset.py:49)
        # bucket the graph axis too (fake graphs have empty masks; their
        # predictions are 0 and ligand_valid excludes them from the loss)
        batch = batch_graphs(graphs, num_graphs_pad=half_octave(len(graphs)))
        arrays = (batch.atom_features, batch.atom_graph, batch.atom_valid, batch.edge_src,
                  batch.edge_dst, batch.edge_features, batch.edge_valid, batch.num_graphs)
        n, ng = len(graphs), batch.num_graphs
        aff = np.zeros(ng, dtype=np.float32)
        aff[:n] = affinities
        valid = np.zeros(ng, dtype=np.float32)
        valid[:n] = 1.0
        self.timings.append(dict(parse_s=t1 - t0, trunk_s=t2 - t1,
                                 featurize_s=time.perf_counter() - t2))
        return PocketItem(
            multi_scale_features=out["pyramid"],
            hotspot_features=hf,
            hotspot_positions=hp,
            hotspot_valid=hv,
            batch_arrays=arrays,
            affinities=aff,
            ligand_valid=valid,
        )


def collate_identity(batch: list[PocketItem]) -> list[PocketItem]:
    """Identity collate (developer trainer.py:185-186)."""
    return batch


# --------------------------------------------------------------------------
# Data-parallel batch preparation: items re-padded to COMMON bucket shapes,
# as the JAX package's DP step stacks them. All padding is exactly masked
# downstream (hotspot rows via hotspot_valid; pad atoms/edges dump into the
# fake graph slot `ng` / the last invalid atom row, both excluded by
# atom_valid / ligand_valid).
# --------------------------------------------------------------------------
def _repad_item(item: PocketItem, k_pad: int, vp: int, ep: int, ng: int) -> PocketItem:
    hf0 = item.hotspot_features
    k0 = hf0.shape[0]
    ai, ag, av, es, ed, ei, ev, ng0 = item.batch_arrays
    ai, ag, av, es, ed, ei, ev = (np.asarray(a) for a in (ai, ag, av, es, ed, ei, ev))
    if (k0, ai.shape[0], es.shape[0], int(ng0)) == (k_pad, vp, ep, ng):
        return item
    vp0, ep0 = ai.shape[0], es.shape[0]

    hf = np.zeros((k_pad, hf0.shape[1]), np.float32)
    hp = np.zeros((k_pad, 3), np.float32)
    hv = np.zeros(k_pad, bool)
    hf[:k0], hp[:k0], hv[:k0] = hf0, item.hotspot_positions, item.hotspot_valid

    ai2 = np.zeros((vp,) + ai.shape[1:], ai.dtype)
    ai2[:vp0] = ai
    # dump rows (invalid atoms) must point at the NEW fake-graph index
    ag2 = np.full(vp, ng, np.int32)
    ag2[:vp0] = np.where(av, ag, ng)
    av2 = np.zeros(vp, bool)
    av2[:vp0] = av
    es2 = np.full(ep, vp - 1, np.int32)
    es2[:ep0] = np.where(ev, es, vp - 1)
    ed2 = np.full(ep, vp - 1, np.int32)
    ed2[:ep0] = np.where(ev, ed, vp - 1)
    ei2 = np.zeros((ep,) + ei.shape[1:], ei.dtype)
    ei2[:ep0] = ei
    ev2 = np.zeros(ep, bool)
    ev2[:ep0] = ev

    aff = np.zeros(ng, np.float32)
    aff[: len(item.affinities)] = item.affinities
    lv = np.zeros(ng, np.float32)
    lv[: len(item.ligand_valid)] = item.ligand_valid
    return PocketItem(
        multi_scale_features=item.multi_scale_features,
        hotspot_features=hf, hotspot_positions=hp, hotspot_valid=hv,
        batch_arrays=(ai2, ag2, av2, es2, ed2, ei2, ev2, ng), affinities=aff, ligand_valid=lv,
    )


def repad_items(items: list[PocketItem]) -> list[PocketItem]:
    """Re-pad a batch of items to their common (maximum) bucket shapes."""
    k = max(i.hotspot_features.shape[0] for i in items)
    vp = max(np.asarray(i.batch_arrays[0]).shape[0] for i in items)
    ep = max(np.asarray(i.batch_arrays[3]).shape[0] for i in items)
    ng = max(int(i.batch_arrays[-1]) for i in items)
    return [_repad_item(i, k, vp, ep, ng) for i in items]
