"""Pocket extraction: residue-distance crop around the binding-site center.

Rebuilds upstream PharmacoNet src/pmnet/data/extract_pocket.py:61-98 without
Biopython or the obabel subprocess: keep whitelisted amino-acid residues with
any heavy atom within ``cutoff`` of the center, and drop hydrogens in-memory
(the reference shells out to ``obabel -d`` for that).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import POCKET_CUTOFF
from .pdb import PDBResidue, load_pdb
from .templates import POCKET_AMINO_ACIDS


def extract_pocket_residues(
    residues: list[PDBResidue],
    center: np.ndarray | tuple[float, float, float],
    cutoff: float = POCKET_CUTOFF,
) -> list[PDBResidue]:
    center = np.asarray(center, dtype=np.float64).reshape(1, 3)
    kept: list[PDBResidue] = []
    for residue in residues:
        if residue.name not in POCKET_AMINO_ACIDS:
            continue
        heavy = [a for a in residue.atoms if "H" not in a.name]
        if not heavy:
            continue
        pos = np.array([a.coords for a in heavy], dtype=np.float64)
        if np.min(np.linalg.norm(pos - center, axis=-1)) < cutoff:
            kept.append(
                PDBResidue(
                    residue.name,
                    residue.chain,
                    residue.resseq,
                    residue.icode,
                    [a for a in residue.atoms if a.atomic_num not in (0, 1)],
                )
            )
    return kept


def extract_pocket(
    protein_pdb_path: str | Path,
    center: np.ndarray | tuple[float, float, float],
    cutoff: float = POCKET_CUTOFF,
) -> list[PDBResidue]:
    return extract_pocket_residues(load_pdb(protein_pdb_path), center, cutoff)
