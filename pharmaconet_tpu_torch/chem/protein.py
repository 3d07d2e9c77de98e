"""Protein interactable-part perception (table-driven, host side).

Rebuilds the behavior of the reference Protein object
(upstream PharmacoNet src/pmnet/data/objects/objects.py:19-141) without OpenBabel:

  * hydrophobic atoms — carbons whose heavy neighbors are all carbon
    (objects.py:76-82; hydrogens never break hydrophobicity)
  * aromatic rings    — 5/6-rings of TYR/TRP/HIS/PHE (objects.py:92-103)
  * charged parts     — side-chain N of ARG/HIS/LYS grouped per residue;
                        side-chain O of GLU/ASP (objects.py:105-129)
  * H-bond donors/acceptors — template roles (objects.py:84-90)
  * X-bond acceptors  — O/N/S with exactly one neighbor Y in {C,N,S}
                        (objects.py:131-141)

Adjacency comes from residue templates plus inter-residue peptide (C-N) and
disulfide (SG-SG) links; unknown residues fall back to geometric bond
perception with covalent radii.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .pdb import PDBAtom, PDBResidue, load_pdb, parse_pdb
from .periodic import COVALENT_RADIUS
from .templates import (
    BACKBONE_ACCEPTORS,
    BACKBONE_DONOR,
    RESIDUE_TEMPLATES,
    RING_RESIDUES,
)

PEPTIDE_BOND_CUTOFF = 1.8
DISULFIDE_CUTOFF = 2.5
GENERIC_BOND_TOLERANCE = 0.45


@dataclass(frozen=True)
class HydrophobicAtom:
    index: int
    coords: tuple[float, float, float]


@dataclass(frozen=True)
class Ring:
    indices: tuple[int, ...]
    center: tuple[float, float, float]


@dataclass(frozen=True)
class ChargedGroup:
    indices: tuple[int, ...]
    center: tuple[float, float, float]


@dataclass(frozen=True)
class HBondPartner:
    index: int
    coords: tuple[float, float, float]


@dataclass(frozen=True)
class XBondAcceptor:
    O_index: int
    Y_index: int
    O_coords: tuple[float, float, float]

    @property
    def indices(self) -> tuple[int, int]:
        return (self.O_index, self.Y_index)


@dataclass
class Protein:
    """Heavy-atom protein model with perceived interactable parts."""

    atoms: list[PDBAtom]
    residues: list[PDBResidue]
    adjacency: list[list[int]]
    hydrophobic_atoms: list[HydrophobicAtom] = field(default_factory=list)
    rings: list[Ring] = field(default_factory=list)
    pos_charged: list[ChargedGroup] = field(default_factory=list)
    neg_charged: list[ChargedGroup] = field(default_factory=list)
    hbond_donors: list[HBondPartner] = field(default_factory=list)
    hbond_acceptors: list[HBondPartner] = field(default_factory=list)
    xbond_acceptors: list[XBondAcceptor] = field(default_factory=list)

    @property
    def num_heavy_atoms(self) -> int:
        return len(self.atoms)

    @property
    def positions(self) -> np.ndarray:
        return np.array([a.coords for a in self.atoms], dtype=np.float32)

    @classmethod
    def from_pdbfile(cls, path: str | Path) -> "Protein":
        return cls.from_residues(load_pdb(path))

    @classmethod
    def from_pdbblock(cls, block: str) -> "Protein":
        return cls.from_residues(parse_pdb(block))

    @classmethod
    def from_residues(cls, residues: list[PDBResidue]) -> "Protein":
        residues = _strip_hydrogens(residues)
        atoms: list[PDBAtom] = []
        atom_index: dict[int, int] = {}  # id(PDBAtom) -> global index
        for residue in residues:
            for atom in residue.atoms:
                atom_index[id(atom)] = len(atoms)
                atoms.append(atom)

        adjacency = _build_adjacency(residues, atoms, atom_index)
        protein = cls(atoms=atoms, residues=residues, adjacency=adjacency)
        protein._perceive(atom_index)
        return protein

    # ------------------------------------------------------------------
    def _perceive(self, atom_index: dict[int, int]) -> None:
        atoms, adjacency = self.atoms, self.adjacency
        nonwater = [
            i
            for i, a in enumerate(atoms)
            if a.resname != "HOH" and a.atomic_num in (6, 7, 8, 16)
        ]
        nonwater_set = set(nonwater)

        # hydrophobic carbons: every heavy neighbor is carbon (objects.py:76-82)
        for i in nonwater:
            if atoms[i].atomic_num != 6:
                continue
            if all(atoms[j].atomic_num == 6 for j in adjacency[i]):
                self.hydrophobic_atoms.append(HydrophobicAtom(i, atoms[i].coords))

        # rings (residue file order; objects.py:92-103)
        for residue in self.residues:
            template = RESIDUE_TEMPLATES.get(residue.name)
            if template is None or residue.name not in RING_RESIDUES:
                continue
            for ring_names in template.rings:
                members = [residue.atom_by_name(n) for n in ring_names]
                if any(m is None for m in members):
                    continue
                indices = tuple(atom_index[id(m)] for m in members)
                center = tuple(np.mean([m.coords for m in members], axis=0).tolist())
                self.rings.append(Ring(indices, center))

        # charged groups (residue order; objects.py:105-129)
        for residue in self.residues:
            template = RESIDUE_TEMPLATES.get(residue.name)
            if template is None:
                continue
            base = residue.name
            if base in ("ARG", "HIS", "LYS") or template.pos_charged:
                members = [
                    residue.atom_by_name(n)
                    for n in template.pos_charged
                ]
                members = [m for m in members if m is not None]
                if members:
                    indices = tuple(atom_index[id(m)] for m in members)
                    center = tuple(np.mean([m.coords for m in members], axis=0).tolist())
                    self.pos_charged.append(ChargedGroup(indices, center))
            if base in ("GLU", "ASP") or template.neg_charged:
                members = [residue.atom_by_name(n) for n in template.neg_charged]
                members = [m for m in members if m is not None]
                if members:
                    indices = tuple(atom_index[id(m)] for m in members)
                    center = tuple(np.mean([m.coords for m in members], axis=0).tolist())
                    self.neg_charged.append(ChargedGroup(indices, center))

        # H-bond donors / acceptors, each list in global atom order
        # (matches OBMolAtomIter filtering; objects.py:84-90)
        donor_flags, acceptor_flags = _hbond_roles(self.residues)
        for i, atom in enumerate(self.atoms):
            if i in nonwater_set and donor_flags.get(id(atom), False):
                self.hbond_donors.append(HBondPartner(i, atom.coords))
        for i, atom in enumerate(self.atoms):
            if i in nonwater_set and acceptor_flags.get(id(atom), False):
                self.hbond_acceptors.append(HBondPartner(i, atom.coords))

        # X-bond acceptors: O/N/S with exactly one neighbor in {C,N,S}
        # (objects.py:131-141)
        for i in nonwater:
            if atoms[i].atomic_num not in (8, 7, 16):
                continue
            ys = [j for j in adjacency[i] if atoms[j].atomic_num in (6, 7, 16)]
            if len(ys) == 1:
                self.xbond_acceptors.append(XBondAcceptor(i, ys[0], atoms[i].coords))


def _strip_hydrogens(residues: list[PDBResidue]) -> list[PDBResidue]:
    out = []
    for residue in residues:
        heavy = [a for a in residue.atoms if a.atomic_num not in (0, 1)]
        if not heavy:
            continue
        out.append(PDBResidue(residue.name, residue.chain, residue.resseq, residue.icode, heavy))
    return out


def _build_adjacency(
    residues: list[PDBResidue],
    atoms: list[PDBAtom],
    atom_index: dict[int, int],
) -> list[list[int]]:
    n = len(atoms)
    adjacency: list[set[int]] = [set() for _ in range(n)]

    def connect(i: int, j: int) -> None:
        adjacency[i].add(j)
        adjacency[j].add(i)

    # intra-residue bonds from templates (or geometric fallback)
    for residue in residues:
        template = RESIDUE_TEMPLATES.get(residue.name)
        if template is not None:
            name_map = {a.name: a for a in residue.atoms}
            for a_name, b_name in template.bonds:
                a, b = name_map.get(a_name), name_map.get(b_name)
                if a is not None and b is not None:
                    connect(atom_index[id(a)], atom_index[id(b)])
        else:
            _geometric_bonds(residue.atoms, atom_index, connect)

    # peptide bonds: C(i) - N(i+1) between consecutive residues in a chain
    for prev, curr in zip(residues, residues[1:]):
        if prev.chain != curr.chain:
            continue
        c = prev.atom_by_name("C")
        nxt = curr.atom_by_name("N")
        if c is not None and nxt is not None:
            if _dist(c, nxt) < PEPTIDE_BOND_CUTOFF:
                connect(atom_index[id(c)], atom_index[id(nxt)])

    # disulfide bridges: SG-SG < 2.5 A
    sgs = [
        a
        for residue in residues
        if residue.name in ("CYS", "CYX")
        for a in residue.atoms
        if a.name == "SG"
    ]
    for i, a in enumerate(sgs):
        for b in sgs[i + 1:]:
            if _dist(a, b) < DISULFIDE_CUTOFF:
                connect(atom_index[id(a)], atom_index[id(b)])

    return [sorted(s) for s in adjacency]


def _geometric_bonds(atoms: list[PDBAtom], atom_index, connect) -> None:
    """Covalent-radius bond perception for residues without a template."""
    for i, a in enumerate(atoms):
        ra = COVALENT_RADIUS.get(a.atomic_num, 0.77)
        for b in atoms[i + 1:]:
            rb = COVALENT_RADIUS.get(b.atomic_num, 0.77)
            if _dist(a, b) < ra + rb + GENERIC_BOND_TOLERANCE:
                connect(atom_index[id(a)], atom_index[id(b)])


def _dist(a: PDBAtom, b: PDBAtom) -> float:
    return float(np.linalg.norm(np.array(a.coords) - np.array(b.coords)))


def _hbond_roles(residues: list[PDBResidue]) -> tuple[dict[int, bool], dict[int, bool]]:
    donors: dict[int, bool] = {}
    acceptors: dict[int, bool] = {}
    for residue in residues:
        template = RESIDUE_TEMPLATES.get(residue.name)
        for atom in residue.atoms:
            is_donor = False
            is_acceptor = False
            if template is not None:
                if atom.name == BACKBONE_DONOR and residue.name != "PRO":
                    is_donor = True
                if atom.name in BACKBONE_ACCEPTORS:
                    is_acceptor = True
                if atom.name in template.donors:
                    is_donor = True
                if atom.name in template.acceptors:
                    is_acceptor = True
            else:
                # generic fallback: N/O are donors and acceptors
                if atom.atomic_num in (7, 8):
                    is_donor = True
                    is_acceptor = True
            donors[id(atom)] = is_donor
            acceptors[id(atom)] = is_acceptor
    return donors, acceptors
