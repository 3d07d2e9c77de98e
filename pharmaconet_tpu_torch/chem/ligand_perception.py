"""Ligand pharmacophore-node perception: functional-group rules.

Rebuilds upstream PharmacoNet src/pmnet/scoring/ligand_utils.py:25-184 on top of
the dependency-free ``Molecule`` model. Node types and their atom/center
index conventions follow the reference exactly:

  * Hydrophobic    — C whose neighbors are all C/H (ligand_utils.py:36-40)
  * Aromatic       — aromatic SSSR rings, sorted by atom-index tuple (47-52)
  * Cation         — quaternary/tertiary amine N, sulfonium S (54-58);
                     guanidine C: atoms=(C, N...), center=C (62-64)
  * Anion          — phosphate/sulfate: atoms=(P/S, neighbors), center=P/S
                     (66-68); sulfonate: atoms=(S, O...), center=S (70-72);
                     carboxylate: atoms=(C, O...), center=O pair (74-76)
  * HBond_donor    — atom with a polar hydrogen (46)
  * HBond_acceptor — non-halogen H-bond acceptor (41-45)
  * Halogen        — F/Cl/Br/I bonded to carbon (78, 178-184)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .periodic import HALOGENS
from .smallmol import Molecule


@dataclass(frozen=True)
class PharmacophoreNode:
    atom_indices: int | tuple[int, ...]
    center_indices: int | tuple[int, ...]

    def get_center(self, atom_positions: np.ndarray) -> np.ndarray:
        if isinstance(self.center_indices, int):
            return atom_positions[self.center_indices]
        return np.mean(atom_positions[list(self.center_indices), :], axis=0)


def _node(atom_indices, center_indices=None) -> PharmacophoreNode:
    if center_indices is None:
        center_indices = atom_indices
    return PharmacophoreNode(atom_indices, center_indices)


# --------------------------------------------------------------------------
# functional-group predicates (ligand_utils.py:94-184 semantics)
# --------------------------------------------------------------------------
def is_quaternary_amine(mol: Molecule, i: int) -> bool:
    atom = mol.atoms[i]
    return (
        atom.atomic_num == 7
        and mol.heavy_degree(i) == 4
        and mol.total_h(i) == 0
    )


def is_tertiary_amine(mol: Molecule, i: int) -> bool:
    atom = mol.atoms[i]
    return atom.atomic_num == 7 and mol.is_sp3(i) and mol.heavy_degree(i) == 3


def is_sulfonium(mol: Molecule, i: int) -> bool:
    atom = mol.atoms[i]
    return atom.atomic_num == 16 and mol.heavy_degree(i) == 3 and mol.total_h(i) == 0


def is_guanidine_carbon(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].atomic_num != 6:
        return False
    neighbors = mol.neighbors(i)
    n_count = 0
    terminal_n = 0
    for j in neighbors:
        if mol.atoms[j].atomic_num == 7:
            n_count += 1
            if mol.heavy_degree(j) == 1:
                terminal_n += 1
        else:
            return False
    return n_count == 3 and terminal_n > 0


def is_sulfonic_sulfur(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].atomic_num != 16:
        return False
    return sum(1 for j in mol.neighbors(i) if mol.atoms[j].atomic_num == 8) == 3


def is_sulfate_sulfur(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].atomic_num != 16:
        return False
    return sum(1 for j in mol.neighbors(i) if mol.atoms[j].atomic_num == 8) == 4


def is_phosphate_phosphorus(mol: Molecule, i: int) -> bool:
    # reference is_phosphate_P (ligand_utils.py:157-163) is vacuously True
    # for a bond-less P (its neighbor loop never rejects) — matched exactly
    if mol.atoms[i].atomic_num != 15:
        return False
    return all(mol.atoms[j].atomic_num == 8 for j in mol.neighbors(i))


def is_carboxylate_carbon(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].atomic_num != 6:
        return False
    num_o = num_c = 0
    for j in mol.neighbors(i):
        z = mol.atoms[j].atomic_num
        if z == 8:
            num_o += 1
        elif z == 6:
            num_c += 1
    return num_o == 2 and num_c == 1


def is_halocarbon(mol: Molecule, i: int) -> bool:
    if mol.atoms[i].atomic_num not in HALOGENS:
        return False
    return any(mol.atoms[j].atomic_num == 6 for j in mol.neighbors(i))


def is_hbond_donor(mol: Molecule, i: int) -> bool:
    """N/O/S bearing at least one hydrogen (polar H semantics)."""
    atom = mol.atoms[i]
    if atom.atomic_num not in (7, 8, 16):
        return False
    return mol.total_h(i) > 0


def is_hbond_acceptor(mol: Molecule, i: int) -> bool:
    """Documented approximation of OBAtom::IsHbondAcceptor for N/O.

    Accepts O (not positively charged) and N with an available lone pair —
    excluding amide/aniline-like conjugated N, aromatic N with three
    connections (pyrrole type), and quaternary N.
    """
    atom = mol.atoms[i]
    if atom.charge > 0:
        return False
    if atom.atomic_num == 8:
        return True
    if atom.atomic_num != 7:
        return False
    degree = mol.heavy_degree(i) + mol.total_h(i)
    if degree >= 4:
        return False
    if atom.aromatic or any(b.aromatic for b in mol.bonds_of(i)):
        # pyridine-type N (2 connections in ring) accepts; pyrrole-type doesn't
        return degree == 2
    # amide N: neighbor carbon with C=O
    for j in mol.neighbors(i):
        if mol.atoms[j].atomic_num == 6:
            for b in mol.bonds_of(j):
                k = b.other(j)
                if b.order == 2 and mol.atoms[k].atomic_num in (8, 16):
                    return False
    return True


# --------------------------------------------------------------------------
def get_pharmacophore_nodes(mol: Molecule) -> dict[str, list[PharmacophoreNode]]:
    """Perceive pharmacophore nodes (H-stripped molecule expected)."""
    hydrophobics = [
        _node(i)
        for i, atom in enumerate(mol.atoms)
        if atom.atomic_num == 6
        and all(mol.atoms[j].atomic_num == 6 for j in mol.neighbors(i))
    ]
    hbond_acceptors = [
        _node(i)
        for i, atom in enumerate(mol.atoms)
        if atom.atomic_num not in HALOGENS and is_hbond_acceptor(mol, i)
    ]
    hbond_donors = [_node(i) for i in range(mol.num_atoms) if is_hbond_donor(mol, i)]

    rings = [_node(tuple(sorted(ring))) for ring in mol.aromatic_rings()]
    rings.sort(key=lambda node: node.atom_indices)

    pos_charged = [
        _node(i)
        for i in range(mol.num_atoms)
        if is_quaternary_amine(mol, i) or is_tertiary_amine(mol, i) or is_sulfonium(mol, i)
    ]
    neg_charged: list[PharmacophoreNode] = []

    for i in range(mol.num_atoms):
        if is_guanidine_carbon(mol, i):
            nitrogens = tuple(j for j in mol.neighbors(i) if mol.atoms[j].atomic_num == 7)
            pos_charged.append(_node((i,) + nitrogens, i))
        elif is_phosphate_phosphorus(mol, i) or is_sulfate_sulfur(mol, i):
            neighbors = tuple(mol.neighbors(i))
            neg_charged.append(_node((i,) + neighbors, i))
        elif is_sulfonic_sulfur(mol, i):
            oxygens = tuple(j for j in mol.neighbors(i) if mol.atoms[j].atomic_num == 8)
            neg_charged.append(_node((i,) + oxygens, i))
        elif is_carboxylate_carbon(mol, i):
            oxygens = tuple(j for j in mol.neighbors(i) if mol.atoms[j].atomic_num == 8)
            neg_charged.append(_node((i,) + oxygens, oxygens))

    xbond_donors = [_node(i) for i in range(mol.num_atoms) if is_halocarbon(mol, i)]

    return {
        "Hydrophobic": hydrophobics,
        "Aromatic": rings,
        "Cation": pos_charged,
        "Anion": neg_charged,
        "HBond_donor": hbond_donors,
        "HBond_acceptor": hbond_acceptors,
        "Halogen": xbond_donors,
    }
