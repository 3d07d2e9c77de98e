"""Host featurization: interaction tokens + 33-channel protein point cloud.

Rebuilds upstream PharmacoNet src/pmnet/data/token_inference.py and
pointcloud.py on top of the table-driven ``Protein`` perception. All outputs
are numpy arrays ready for padding and device transfer.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..chem.protein import Protein


def get_token_informations(protein: Protein) -> tuple[np.ndarray, np.ndarray]:
    """Token center positions + interaction classes (token_inference.py:10-79).

    Emission order (part of the model contract):
      Hydrophobic atoms, rings as PiStacking_P, rings as PiStacking_T,
      cations as PiCation_lring, rings as PiCation_pring, acceptors as
      HBond_ldon, donors as HBond_pdon, cations as SaltBridge_lneg,
      anions as SaltBridge_pneg, X-bond acceptors as XBond.
    """
    positions: list[tuple[float, float, float]] = []
    classes: list[int] = []

    def emit(coords_iter, cls: int) -> None:
        for coords in coords_iter:
            positions.append(coords)
            classes.append(cls)

    emit((h.coords for h in protein.hydrophobic_atoms), C.HYDROPHOBIC)
    emit((r.center for r in protein.rings), C.PISTACKING_P)
    emit((r.center for r in protein.rings), C.PISTACKING_T)
    emit((p.center for p in protein.pos_charged), C.PICATION_LRING)
    emit((r.center for r in protein.rings), C.PICATION_PRING)
    emit((a.coords for a in protein.hbond_acceptors), C.HBOND_LDON)
    emit((d.coords for d in protein.hbond_donors), C.HBOND_PDON)
    emit((p.center for p in protein.pos_charged), C.SALTBRIDGE_LNEG)
    emit((n.center for n in protein.neg_charged), C.SALTBRIDGE_PNEG)
    emit((x.O_coords for x in protein.xbond_acceptors), C.XBOND)

    if not positions:
        return np.zeros((0, 3), dtype=np.float32), np.zeros((0,), dtype=np.int16)
    return np.array(positions, dtype=np.float32), np.array(classes, dtype=np.int16)


def get_token_and_filter(
    positions: np.ndarray,
    classes: np.ndarray,
    center: np.ndarray,
    resolution: float = C.GRID_RESOLUTION,
    dimension: int = C.GRID_DIM,
) -> tuple[np.ndarray, np.ndarray]:
    """Grid-quantize tokens, dropping out-of-box ones (token_inference.py:82-115).

    Uses the token-grid origin convention: start = center - (dim/2)*res,
    voxel index = floor((pos - start) / res).
    """
    if positions.shape[0] == 0:
        return np.zeros((0, 4), dtype=np.int16), np.zeros((0,), dtype=np.int64)
    start = np.asarray(center, dtype=np.float64) - (dimension / 2) * resolution
    voxel = np.floor((positions.astype(np.float64) - start) / resolution).astype(np.int64)
    inside = np.all((voxel >= 0) & (voxel < dimension), axis=1)
    keep = np.nonzero(inside)[0]
    tokens = np.concatenate(
        [voxel[keep], classes[keep].astype(np.int64)[:, None]], axis=1
    ).astype(np.int16)
    return tokens, keep


def get_protein_pointcloud(protein: Protein) -> tuple[np.ndarray, np.ndarray]:
    """Positions + 33-channel one-hot features (pointcloud.py:70-97).

    Channels: 5 atom types (C,N,O,S,UNK), 21 residue types, 7 interactable
    flags (HydrophobicAtom, Ring, HBondDonor, HBondAcceptor, Cation, Anion,
    XBondAcceptor).
    """
    positions = protein.positions
    n = protein.num_heavy_atoms
    channels = np.zeros((n, C.NUM_PROTEIN_CHANNELS), dtype=np.float32)

    atom_num_index = {z: i for i, z in enumerate(C.PROTEIN_ATOM_NUMS)}
    aa_index = {name: i for i, name in enumerate(C.PROTEIN_AMINO_ACIDS)}
    for i, atom in enumerate(protein.atoms):
        channels[i, atom_num_index.get(atom.atomic_num, C.NUM_PROTEIN_ATOM_CHANNELS - 1)] = 1.0
        aa_ch = aa_index.get(atom.resname, C.NUM_PROTEIN_AA_CHANNELS - 1)
        channels[i, C.NUM_PROTEIN_ATOM_CHANNELS + aa_ch] = 1.0

    offset = C.NUM_PROTEIN_ATOM_CHANNELS + C.NUM_PROTEIN_AA_CHANNELS
    for h in protein.hydrophobic_atoms:
        channels[h.index, offset] = 1.0
    for ring in protein.rings:
        channels[list(ring.indices), offset + 1] = 1.0
    for d in protein.hbond_donors:
        channels[d.index, offset + 2] = 1.0
    for a in protein.hbond_acceptors:
        channels[a.index, offset + 3] = 1.0
    for p in protein.pos_charged:
        channels[list(p.indices), offset + 4] = 1.0
    for ng in protein.neg_charged:
        channels[list(ng.indices), offset + 5] = 1.0
    for x in protein.xbond_acceptors:
        channels[list(x.indices), offset + 6] = 1.0
    return positions, channels


def get_box_area_host(
    tokens: np.ndarray,
    resolution: float = C.GRID_RESOLUTION,
    dimension: int = C.GRID_DIM,
) -> np.ndarray:
    """Per-token spherical box mask [N, D, H, W] (token_inference.py:118-146).

    Host/numpy version for tests; the device program computes the same mask
    on the fly (see ops.postprocess).
    """
    num = len(tokens)
    out = np.zeros((num, dimension, dimension, dimension), dtype=np.bool_)
    axes = np.arange(dimension)
    gx, gy, gz = np.meshgrid(axes, axes, axes, indexing="ij")
    for i, (x, y, z, t) in enumerate(np.asarray(tokens, dtype=np.int64)):
        threshold = C.box_radius_voxels(int(t), resolution)
        dist = np.sqrt((gx - x) ** 2 + (gy - y) ** 2 + (gz - z) ** 2)
        out[i] = dist < threshold
    return out
