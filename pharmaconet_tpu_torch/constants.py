"""Global constants: interaction taxonomy, grid geometry, thresholds.

TPU-native rebuild of the tables in the reference implementation
(upstream PharmacoNet src/pmnet/data/constant.py:3-57, module.py:30-43,
pharmacophore_model.py:22-47). Values are part of the model contract
(the frozen network was trained against them) and must not change.
"""

from __future__ import annotations

import math
from typing import Final

# --------------------------------------------------------------------------
# Interaction taxonomy (order matters: it is the network's class indexing)
# (reference: data/constant.py:3-27)
# --------------------------------------------------------------------------
INTERACTION_LIST: Final[tuple[str, ...]] = (
    "Hydrophobic",
    "PiStacking_P",
    "PiStacking_T",
    "PiCation_lring",
    "PiCation_pring",
    "HBond_ldon",
    "HBond_pdon",
    "SaltBridge_lneg",
    "SaltBridge_pneg",
    "XBond",
)

NUM_INTERACTION_TYPES: Final[int] = len(INTERACTION_LIST)

HYDROPHOBIC: Final[int] = 0
PISTACKING_P: Final[int] = 1
PISTACKING_T: Final[int] = 2
PICATION_LRING: Final[int] = 3
PICATION_PRING: Final[int] = 4
HBOND_LDON: Final[int] = 5
HBOND_PDON: Final[int] = 6
SALTBRIDGE_LNEG: Final[int] = 7
SALTBRIDGE_PNEG: Final[int] = 8
XBOND: Final[int] = 9

# PLIP interaction cutoff distances + 0.5 A margin (reference: constant.py:30-41)
INTERACTION_DIST: Final[dict[int, float]] = {
    HYDROPHOBIC: 4.5,
    PISTACKING_P: 6.0,
    PISTACKING_T: 6.0,
    PICATION_LRING: 6.5,
    PICATION_PRING: 6.5,
    HBOND_LDON: 4.5,
    HBOND_PDON: 4.5,
    SALTBRIDGE_LNEG: 6.0,
    SALTBRIDGE_PNEG: 6.0,
    XBOND: 4.5,
}

# Long-range interactions gate on the wide cavity, short on the narrow one
# (reference: constant.py:43-57, module.py:246-251)
LONG_INTERACTION: Final[frozenset[int]] = frozenset(
    {PISTACKING_P, PISTACKING_T, PICATION_PRING, PICATION_LRING, SALTBRIDGE_LNEG, SALTBRIDGE_PNEG}
)
SHORT_INTERACTION: Final[frozenset[int]] = frozenset({HYDROPHOBIC, HBOND_LDON, HBOND_PDON, XBOND})

# Per-interaction box radius in voxels: ceil((dist + pharmacophore_size) / resolution)
# (reference: token_inference.py:129-145)
PHARMACOPHORE_SIZE: Final[float] = 1.0


def box_radius_voxels(interaction_type: int, resolution: float = 0.5) -> int:
    return math.ceil((INTERACTION_DIST[interaction_type] + PHARMACOPHORE_SIZE) / resolution)


# --------------------------------------------------------------------------
# Voxel grid geometry.
#
# NOTE there are TWO origin conventions in the reference, both reproduced here:
#   * token grid:   start = center - (dim/2) * res          (token_inference.py:104-106)
#   * node position: origin = center - res * (dim-1)/2      (density_map.py:16-25)
# --------------------------------------------------------------------------
GRID_RESOLUTION: Final[float] = 0.5
GRID_DIM: Final[int] = 64

# Pocket extraction residue-distance cutoff (reference: extract_pocket.py:83)
POCKET_CUTOFF: Final[float] = 16.0 * math.sqrt(3.0) + 5.0

# --------------------------------------------------------------------------
# Thresholds (reference: module.py:30-43)
# --------------------------------------------------------------------------
DEFAULT_FOCUS_THRESHOLD: Final[float] = 0.5
DEFAULT_BOX_THRESHOLD: Final[float] = 0.5
DEFAULT_SCORE_THRESHOLD: Final[dict[str, float]] = {
    "PiStacking_P": 0.7,
    "PiStacking_T": 0.7,
    "SaltBridge_lneg": 0.7,
    "SaltBridge_pneg": 0.7,
    "PiCation_lring": 0.7,
    "PiCation_pring": 0.7,
    "XBond": 0.85,
    "HBond_ldon": 0.85,
    "HBond_pdon": 0.85,
    "Hydrophobic": 0.85,
}

# --------------------------------------------------------------------------
# Interaction type -> pharmacophore / hotspot naming
# (reference: pharmacophore_model.py:22-47)
# --------------------------------------------------------------------------
INTERACTION_TO_PHARMACOPHORE: Final[dict[str, str]] = {
    "Hydrophobic": "Hydrophobic",
    "PiStacking_P": "Aromatic",
    "PiStacking_T": "Aromatic",
    "PiCation_lring": "Aromatic",
    "PiCation_pring": "Cation",
    "HBond_pdon": "HBond_acceptor",
    "HBond_ldon": "HBond_donor",
    "SaltBridge_pneg": "Cation",
    "SaltBridge_lneg": "Anion",
    "XBond": "Halogen",
}

INTERACTION_TO_HOTSPOT: Final[dict[str, str]] = {
    "Hydrophobic": "Hydrophobic",
    "PiStacking_P": "Aromatic",
    "PiStacking_T": "Aromatic",
    "PiCation_lring": "Cation",
    "PiCation_pring": "Aromatic",
    "HBond_pdon": "HBond_donor",
    "HBond_ldon": "HBond_acceptor",
    "SaltBridge_pneg": "Anion",
    "SaltBridge_lneg": "Cation",
    "XBond": "Halogen",
}

# --------------------------------------------------------------------------
# Protein point-cloud feature channels (reference: pointcloud.py:9-49)
# --------------------------------------------------------------------------
PROTEIN_ATOM_NUMS: Final[tuple[int, ...]] = (6, 7, 8, 16, -1)
PROTEIN_ATOM_SYMBOLS: Final[tuple[str, ...]] = ("C", "N", "O", "S", "UNK_ATOM")
PROTEIN_AMINO_ACIDS: Final[tuple[str, ...]] = (
    "GLY", "ALA", "VAL", "LEU", "ILE", "PRO", "PHE", "TYR", "TRP", "SER",
    "THR", "CYS", "MET", "ASN", "GLN", "ASP", "GLU", "LYS", "ARG", "HIS",
    "UNK_AA",
)
PROTEIN_INTERACTABLES: Final[tuple[str, ...]] = (
    "HydrophobicAtom",
    "Ring",
    "HBondDonor",
    "HBondAcceptor",
    "Cation",
    "Anion",
    "XBondAcceptor",
)

NUM_PROTEIN_ATOM_CHANNELS: Final[int] = len(PROTEIN_ATOM_NUMS)
NUM_PROTEIN_AA_CHANNELS: Final[int] = len(PROTEIN_AMINO_ACIDS)
NUM_PROTEIN_INTERACTABLE_CHANNELS: Final[int] = len(PROTEIN_INTERACTABLES)
NUM_PROTEIN_CHANNELS: Final[int] = (
    NUM_PROTEIN_ATOM_CHANNELS + NUM_PROTEIN_AA_CHANNELS + NUM_PROTEIN_INTERACTABLE_CHANNELS
)  # 33

# Voxelization radii (reference: parser.py:96-99)
FEATURE_RADII: Final[float] = 1.5
MASK_RADII: Final[float] = 1.0
VOXELIZER_SIGMA: Final[float] = 1.0 / 3.0

# --------------------------------------------------------------------------
# Density-map graph clustering (reference: density_map.py:12-13, add_node:60)
# --------------------------------------------------------------------------
OVERLAP_DISTANCE: Final[float] = 1.5
CLUSTER_DISTANCE: Final[float] = 3.0
MIN_NODE_VOXELS: Final[int] = 8

# --------------------------------------------------------------------------
# Scoring defaults (reference: graph_match.py:32-40, tree.py:98, numba kernels)
# --------------------------------------------------------------------------
DEFAULT_WEIGHTS: Final[dict[str, float]] = {
    "Cation": 8.0,
    "Anion": 8.0,
    "Aromatic": 4.0,
    "HBond_donor": 4.0,
    "HBond_acceptor": 4.0,
    "Halogen": 4.0,
    "Hydrophobic": 1.0,
}
MAX_MATCH_DEPTH: Final[int] = 20  # ligand clusters per graph (graph_match.py:88)
MIN_MATCHES_FOR_SKIP: Final[int] = 5  # tree.py:98 None-branch condition
# numba kernel semantics (match_utils_numba.py:59,80): pass iff ((d-mu)/std)^2 < 4.0,
# block passes iff num_pass >= (M*N+1)//2
SIGMA_SQ_PASS: Final[float] = 4.0

# --------------------------------------------------------------------------
# Padding caps for fixed-shape device programs (TPU build specific)
# --------------------------------------------------------------------------
MAX_TOKENS: Final[int] = 2048
MAX_HOTSPOTS: Final[int] = 128
SEGMENTATION_CHUNK: Final[int] = 16
MAX_ATOMS: Final[int] = 8192
