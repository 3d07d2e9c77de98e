"""Dependency-free small-molecule model and its perception: a frozen copy
of `pharmaconet_tpu_torch/chem/smallmol.py` without its SDF/MOL2/PDB
parsers (the benchmark's molecules come from SMILES).

The reference reads ligands with OpenBabel (pybel) and perceives pharmacophore
features through OBAtom queries (upstream PharmacoNet src/pmnet/scoring/ligand.py,
ligand_utils.py). This rebuild implements the same functional-group rules on
a plain connection table.

A ``Molecule`` stores heavy atoms only; hydrogens found in the file are
folded into per-atom ``h_count`` (the reference's ``removeh()`` +
``AddPolarHydrogens`` dance reduces to knowing how many H each heavy atom
bears, which is also derivable from valence for H-depleted files).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .periodic import COVALENT_RADIUS, DEFAULT_VALENCE, element_to_z


@dataclass
class Atom:
    atomic_num: int
    charge: int = 0
    h_count: int = 0  # explicit H (from file) folded in at strip time
    aromatic: bool = False
    name: str = ""


@dataclass
class Bond:
    a: int
    b: int
    order: int  # 1,2,3; 4 = aromatic, 5 = amide (mol2 'am')
    aromatic: bool = False

    def other(self, i: int) -> int:
        return self.b if i == self.a else self.a


@dataclass
class Molecule:
    atoms: list[Atom] = field(default_factory=list)
    bonds: list[Bond] = field(default_factory=list)
    coords: np.ndarray | None = None  # [num_atoms, 3] float32
    title: str = ""

    # ------------------------------------------------------------------
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> list[int]:
        return self._adjacency()[i]

    def bonds_of(self, i: int) -> list[Bond]:
        return self._bond_map()[i]

    def _adjacency(self) -> list[list[int]]:
        if not hasattr(self, "_adj"):
            adj: list[list[int]] = [[] for _ in self.atoms]
            for bond in self.bonds:
                adj[bond.a].append(bond.b)
                adj[bond.b].append(bond.a)
            self._adj = adj
        return self._adj

    def _bond_map(self) -> list[list[Bond]]:
        if not hasattr(self, "_bmap"):
            bmap: list[list[Bond]] = [[] for _ in self.atoms]
            for bond in self.bonds:
                bmap[bond.a].append(bond)
                bmap[bond.b].append(bond)
            self._bmap = bmap
        return self._bmap

    def invalidate_caches(self) -> None:
        for attr in ("_adj", "_bmap", "_rings"):
            if hasattr(self, attr):
                delattr(self, attr)

    # ------------------------------------------------------------------
    def heavy_degree(self, i: int) -> int:
        return len(self.neighbors(i))

    def total_h(self, i: int) -> int:
        """Hydrogens on atom i: explicit (stripped) + implicit by valence."""
        atom = self.atoms[i]
        if atom.h_count > 0:
            return atom.h_count
        valence = DEFAULT_VALENCE.get(atom.atomic_num)
        if valence is None:
            return 0
        order_sum = 0
        for bond in self.bonds_of(i):
            order_sum += {1: 1, 2: 2, 3: 3, 4: 1.5, 5: 1}[bond.order]
        # aromatic ring atoms get one extra half-bond rounded up
        order_sum = int(np.ceil(order_sum))
        return max(0, valence + atom.charge - order_sum)

    def has_double_bond(self, i: int) -> bool:
        return any(b.order == 2 for b in self.bonds_of(i))

    def is_sp3(self, i: int) -> bool:
        return all(b.order in (1, 5) and not b.aromatic for b in self.bonds_of(i)) and not self.atoms[i].aromatic

    # ------------------------------------------------------------------
    def strip_hydrogens(self) -> "Molecule":
        """Return a copy without H atoms; H counts folded into neighbors."""
        keep = [i for i, a in enumerate(self.atoms) if a.atomic_num != 1]
        remap = {old: new for new, old in enumerate(keep)}
        atoms = []
        for old in keep:
            a = self.atoms[old]
            atoms.append(Atom(a.atomic_num, a.charge, a.h_count, a.aromatic, a.name))
        bonds = []
        for bond in self.bonds:
            za, zb = self.atoms[bond.a].atomic_num, self.atoms[bond.b].atomic_num
            if za == 1 and zb != 1:
                atoms[remap[bond.b]].h_count += 1
            elif zb == 1 and za != 1:
                atoms[remap[bond.a]].h_count += 1
            elif za != 1 and zb != 1:
                bonds.append(Bond(remap[bond.a], remap[bond.b], bond.order, bond.aromatic))
        coords = self.coords[keep] if self.coords is not None else None
        return Molecule(atoms=atoms, bonds=bonds, coords=coords, title=self.title)

    # ------------------------------------------------------------------
    def rings(self) -> list[tuple[int, ...]]:
        """Smallest rings (SSSR-like): smallest cycle through each ring bond."""
        if hasattr(self, "_rings"):
            return self._rings
        found: set[tuple[int, ...]] = set()
        adj = self._adjacency()
        for bond in self.bonds:
            ring = _smallest_ring_through(adj, bond.a, bond.b)
            if ring is not None:
                found.add(_canonical_ring(ring))
        out = sorted(found, key=lambda r: (len(r), r))
        self._rings = out
        return out

    def aromatic_rings(self) -> list[tuple[int, ...]]:
        """5/6-membered rings passing a pragmatic Hückel test."""
        out = []
        for ring in self.rings():
            if len(ring) not in (5, 6):
                continue
            if self._ring_is_aromatic(ring):
                out.append(ring)
        return out

    def _ring_is_aromatic(self, ring: tuple[int, ...]) -> bool:
        ring_set = set(ring)
        # if the file marked everything aromatic, trust it
        ring_bonds = [
            b for b in self.bonds if b.a in ring_set and b.b in ring_set
        ]
        if ring_bonds and all(b.aromatic or b.order == 4 for b in ring_bonds):
            return True
        pi = 0
        for i in ring:
            atom = self.atoms[i]
            if atom.atomic_num not in (6, 7, 8, 16):
                return False
            in_ring_double = any(
                b.order == 2 and b.other(i) in ring_set for b in self.bonds_of(i)
            )
            exo_double = any(
                b.order == 2 and b.other(i) not in ring_set for b in self.bonds_of(i)
            )
            if in_ring_double:
                pi += 1
            elif exo_double:
                pi += 0  # carbonyl-like carbon contributes an empty p orbital
            elif atom.atomic_num in (7, 8, 16):
                pi += 2  # lone pair (pyrrole N, furan O, thiophene S)
            else:
                return False  # sp3 carbon breaks aromaticity
            # sp3 geometry check: >3 heavy neighbors + H disqualifies
            if self.heavy_degree(i) + self.total_h(i) > 3:
                return False
        return pi % 4 == 2

    def num_rotatable_bonds(self) -> int:
        ring_bonds = set()
        for ring in self.rings():
            ring_set = set(ring)
            for b in self.bonds:
                if b.a in ring_set and b.b in ring_set:
                    ring_bonds.add((b.a, b.b))
        n = 0
        for b in self.bonds:
            if b.order != 1 or (b.a, b.b) in ring_bonds:
                continue
            if self.heavy_degree(b.a) >= 2 and self.heavy_degree(b.b) >= 2:
                n += 1
        return n


def _smallest_ring_through(adj: list[list[int]], a: int, b: int) -> list[int] | None:
    """BFS from a to b avoiding the (a, b) edge; returns the smallest cycle."""
    from collections import deque

    parents = {a: -1}
    queue = deque([a])
    while queue:
        u = queue.popleft()
        for v in adj[u]:
            if u == a and v == b:
                continue
            if v not in parents:
                parents[v] = u
                if v == b:
                    path = [v]
                    while path[-1] != a:
                        path.append(parents[path[-1]])
                    return path
                if len(parents) < 1024:
                    queue.append(v)
    return None


def _canonical_ring(ring: list[int]) -> tuple[int, ...]:
    return tuple(sorted(ring))


# ==========================================================================
# Parsers
# ==========================================================================
