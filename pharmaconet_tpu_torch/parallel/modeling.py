"""Pocket modeling over a device list (`pharmaconet_tpu/parallel/modeling.py`).

`ShardedModeler` scales throughput: a batch of pockets is split into
contiguous shares, one per device, and each pocket runs the whole
single-pocket program (K6, the SwinV2-3D trunk and FPN, the heads, the
segmentation of every kept token) on that device's replica of the
network. `ShardedSegmenter` scales one pocket's latency: the trunk runs
once, and the kept tokens' segmentation chunks are split over the
devices, each with its own copy of the pyramid and the masks.

Both return what `PharmacoNet.create_density_maps` returns for each
pocket, map by map: each chunk holds the same tokens as on the single
path. The JAX modeler pads pockets to common shapes (`_pad_axis0`) and
re-runs token-rich pockets on the single path, because its one program
segments at most `max_hotspots` tokens; eager torch needs neither.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..module import PharmacoNet, ProteinData
from ..pharmacophore.model import PharmacophoreModel
from .mesh import contiguous_shares, data_mesh, on_device


class ShardedModeler:
    """Models a batch of pockets, a contiguous share per device.

    mesh: a device list (`data_mesh`), every visible CUDA device by
    default; the replicas on devices other than `pmnet`'s are copied here,
    so build the modeler after the weights are loaded."""

    def __init__(self, pmnet: PharmacoNet, mesh=None):
        self.pmnet = pmnet
        self.mesh = data_mesh(mesh)
        self._replicas = [on_device(pmnet, d) for d in self.mesh]

    def create_density_maps_batch(self, datas: list[ProteinData]) -> list[list[dict[str, Any]]]:
        """Per-pocket hotspot infos for a batch of parsed pockets, in input
        order. Round r launches the trunk of every share's r-th pocket
        before it reads any of them back, then segments them in mesh
        order."""
        shares = [datas[a:b] for a, b in contiguous_shares(len(datas), len(self.mesh))]
        results: list[list] = [[] for _ in shares]
        for r in range(max(map(len, shares), default=0)):
            outs = [(k, self._replicas[k].run_trunk(share[r]))
                    for k, share in enumerate(shares) if r < len(share)]
            for k, out in outs:
                keep_idx = np.nonzero(out["keep"].cpu().numpy())[0]
                results[k].append(self._replicas[k]._segment_kept(shares[k][r], out, keep_idx))
        return [infos for share in results for infos in share]

    def run_batch(self, jobs: list[tuple]) -> list[PharmacophoreModel]:
        """jobs: (protein pdb path, ref ligand path or None, centre or
        None). Parses on the host, models every pocket over the mesh."""
        datas = [self.pmnet.parse(path, ref_ligand_path=ref, center=center)
                 for path, ref, center in jobs]
        infos = self.create_density_maps_batch(datas)
        return [PharmacophoreModel.create(d.pdbblock, d.center, hi, size=self.pmnet.grid_dim)
                for d, hi in zip(datas, infos)]


class ShardedSegmenter:
    """One pocket's segmentation fanned out over a device list.

    The kept tokens are padded to a multiple of `len(mesh) *
    segmentation_chunk`, as the JAX segmenter pads them, and each device
    takes a contiguous share of whole chunks; a chunk of padding alone is
    skipped. The pyramid, the protein mask, the narrow cavity and the token
    features are copied to each device."""

    def __init__(self, pmnet: PharmacoNet, mesh=None):
        self.pmnet = pmnet
        self.mesh = data_mesh(mesh)
        self._replicas = [on_device(pmnet, d) for d in self.mesh]

    def segment(self, data: ProteinData, out: dict[str, Any],
                keep_idx: np.ndarray) -> list[dict[str, Any]]:
        """Hotspot infos of the token indices `keep_idx` (the contract of
        `PharmacoNet._segment_kept`): every chunk is launched on its device
        before any is read back, then the infos are joined in mesh order."""
        n = len(keep_idx)
        if n == 0:
            return []
        chunk = self.pmnet.segmentation_chunk
        step = len(self.mesh) * chunk
        k_total = -(-n // step) * step
        idx = np.zeros(k_total, dtype=np.int64)
        idx[:n] = keep_idx
        valid = np.arange(k_total) < n
        per_device = k_total // len(self.mesh)
        rel_scores = out["rel_scores"].cpu().numpy()
        launched = []
        for k, rep in enumerate(self._replicas):
            dev_out = {
                "pyramid": [p.to(rep.device) for p in out["pyramid"]],
                "protein_mask": out["protein_mask"].to(rep.device),
                "cavity_narrow": out["cavity_narrow"].to(rep.device),
                "token_features": out["token_features"].to(rep.device),
            }
            tokens = rep._tensor(data.tokens)
            for s in range(k * per_device, (k + 1) * per_device, chunk):
                part, ok = idx[s : s + chunk], valid[s : s + chunk]
                if ok.any():
                    launched.append((rep, part, ok, *rep.segment(dev_out, tokens, part, ok)))
        infos: list[dict[str, Any]] = []
        for rep, part, ok, density, sparse in launched:
            infos += rep.hotspot_infos_from_outputs(data, part, ok, rel_scores, density,
                                                    sparse=sparse)
        return infos

    def create_density_maps(self, data: ProteinData) -> list[dict[str, Any]]:
        """Single-pocket modeling with the segmentation over the mesh."""
        out = self.pmnet.run_trunk(data)
        return self.segment(data, out, np.nonzero(out["keep"].cpu().numpy())[0])

    def run(self, protein_pdb_path, ref_ligand_path=None, center=None) -> PharmacophoreModel:
        data = self.pmnet.parse(protein_pdb_path, ref_ligand_path, center)
        infos = self.create_density_maps(data)
        return PharmacophoreModel.create(data.pdbblock, data.center, infos,
                                         size=self.pmnet.grid_dim)
