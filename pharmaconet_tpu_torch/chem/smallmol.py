"""Dependency-free small-molecule model: SDF/MOL2/PDB parsing + perception.

The reference reads ligands with OpenBabel (pybel) and perceives pharmacophore
features through OBAtom queries (upstream PharmacoNet src/pmnet/scoring/ligand.py,
ligand_utils.py). This rebuild parses the connection table directly from the
file (SDF V2000 bond block, MOL2 bond records, geometric perception for PDB)
and implements the same functional-group rules on top of it.

A ``Molecule`` stores heavy atoms only; hydrogens found in the file are
folded into per-atom ``h_count`` (the reference's ``removeh()`` +
``AddPolarHydrogens`` dance reduces to knowing how many H each heavy atom
bears, which is also derivable from valence for H-depleted files).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

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
def _open_text(path: str | Path) -> str:
    path = str(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


def parse_sdf(text: str, max_mols: int | None = None) -> list[Molecule]:
    """Parse an SDF/MOL (V2000) string into molecules (H retained)."""
    mols: list[Molecule] = []
    blocks = text.split("$$$$")
    for block in blocks:
        lines = block.splitlines()
        # skip leading blank lines between records
        while lines and not lines[0].strip() and len(lines) > 4:
            lines = lines[1:]
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            natoms = int(counts[0:3])
            nbonds = int(counts[3:6])
        except (ValueError, IndexError):
            continue
        if len(lines) < 4 + natoms + nbonds:
            continue
        atoms: list[Atom] = []
        coords = np.zeros((natoms, 3), dtype=np.float32)
        ok = True
        for i in range(natoms):
            ln = lines[4 + i]
            try:
                coords[i] = (float(ln[0:10]), float(ln[10:20]), float(ln[20:30]))
                symbol = ln[31:34].strip()
            except (ValueError, IndexError):
                ok = False
                break
            z = element_to_z(symbol)
            charge_code = 0
            try:
                charge_code = int(ln[36:39])
            except (ValueError, IndexError):
                pass
            charge = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}.get(charge_code, 0)
            atoms.append(Atom(atomic_num=z, charge=charge, name=symbol))
        if not ok:
            continue
        bonds: list[Bond] = []
        for i in range(nbonds):
            ln = lines[4 + natoms + i]
            try:
                a = int(ln[0:3]) - 1
                b = int(ln[3:6]) - 1
                order = int(ln[6:9])
            except (ValueError, IndexError):
                ok = False
                break
            if not (0 <= a < natoms and 0 <= b < natoms):
                ok = False
                break
            bonds.append(Bond(a, b, order if order in (1, 2, 3, 4) else 1, aromatic=(order == 4)))
        if not ok:
            continue
        # property block: M  CHG overrides
        for ln in lines[4 + natoms + nbonds:]:
            if ln.startswith("M  CHG"):
                fields = ln.split()
                n = int(fields[2])
                for k in range(n):
                    idx = int(fields[3 + 2 * k]) - 1
                    chg = int(fields[4 + 2 * k])
                    if 0 <= idx < natoms:
                        atoms[idx].charge = chg
            elif ln.startswith("M  END"):
                break
        mol = Molecule(atoms=atoms, bonds=bonds, coords=coords, title=lines[0].strip())
        mols.append(mol)
        if max_mols is not None and len(mols) >= max_mols:
            break
    return mols


_MOL2_ORDER = {"1": 1, "2": 2, "3": 3, "am": 5, "ar": 4, "du": 1, "un": 1, "nc": 0}


def parse_mol2(text: str, max_mols: int | None = None) -> list[Molecule]:
    mols: list[Molecule] = []
    chunks = text.split("@<TRIPOS>MOLECULE")[1:]
    for chunk in chunks:
        lines = chunk.splitlines()
        title = lines[1].strip() if len(lines) > 1 else ""
        atoms: list[Atom] = []
        coords_list: list[tuple[float, float, float]] = []
        bonds: list[Bond] = []
        section = None
        for ln in lines:
            if ln.startswith("@<TRIPOS>"):
                section = ln.strip()
                continue
            if section == "@<TRIPOS>ATOM" and ln.strip():
                fields = ln.split()
                if len(fields) < 6:
                    continue
                x, y, z = float(fields[2]), float(fields[3]), float(fields[4])
                sybyl = fields[5]
                element = sybyl.split(".")[0]
                charge = 0
                if len(fields) >= 9:
                    try:
                        pc = float(fields[8])
                        charge = int(round(pc)) if abs(pc - round(pc)) < 0.01 and abs(pc) >= 0.99 else 0
                    except ValueError:
                        charge = 0
                atoms.append(
                    Atom(
                        atomic_num=element_to_z(element),
                        charge=charge,
                        aromatic=sybyl.endswith(".ar"),
                        name=fields[1],
                    )
                )
                coords_list.append((x, y, z))
            elif section == "@<TRIPOS>BOND" and ln.strip():
                fields = ln.split()
                if len(fields) < 4:
                    continue
                a, b = int(fields[1]) - 1, int(fields[2]) - 1
                order = _MOL2_ORDER.get(fields[3].lower(), 1)
                if order == 0:
                    continue
                bonds.append(Bond(a, b, order, aromatic=(order == 4)))
        if atoms:
            mols.append(
                Molecule(
                    atoms=atoms,
                    bonds=bonds,
                    coords=np.array(coords_list, dtype=np.float32),
                    title=title,
                )
            )
        if max_mols is not None and len(mols) >= max_mols:
            break
    return mols


def parse_ligand_pdb(text: str, max_mols: int | None = None) -> list[Molecule]:
    """PDB ligand: ATOM/HETATM + CONECT records, geometric-bond fallback."""
    atoms: list[Atom] = []
    coords_list: list[tuple[float, float, float]] = []
    serial_map: dict[int, int] = {}
    conect: list[tuple[int, int]] = []
    for line in text.splitlines():
        record = line[:6]
        if record in ("ATOM  ", "HETATM") and len(line) >= 54:
            element = line[76:78].strip().upper() if len(line) >= 78 else ""
            name = line[12:16].strip()
            if not element:
                element = next((c for c in name if c.isalpha()), "C").upper()
            try:
                serial = int(line[6:11])
                xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            except ValueError:
                continue
            serial_map[serial] = len(atoms)
            atoms.append(Atom(atomic_num=element_to_z(element), name=name))
            coords_list.append(xyz)
        elif record.startswith("CONECT"):
            fields = line.split()[1:]
            try:
                serials = [int(f) for f in fields]
            except ValueError:
                continue
            for other in serials[1:]:
                conect.append((serials[0], other))
        elif record == "ENDMDL":
            break
    if not atoms:
        return []
    coords = np.array(coords_list, dtype=np.float32)
    bonds: list[Bond] = []
    seen = set()
    for sa, sb in conect:
        if sa in serial_map and sb in serial_map:
            a, b = serial_map[sa], serial_map[sb]
            key = (min(a, b), max(a, b))
            if a != b and key not in seen:
                seen.add(key)
                bonds.append(Bond(key[0], key[1], 1))
    if not bonds:
        # geometric fallback with covalent radii
        n = len(atoms)
        for i in range(n):
            ri = COVALENT_RADIUS.get(atoms[i].atomic_num, 0.77)
            d = np.linalg.norm(coords[i + 1:] - coords[i], axis=-1)
            for off, dist in enumerate(d):
                j = i + 1 + off
                rj = COVALENT_RADIUS.get(atoms[j].atomic_num, 0.77)
                if dist < ri + rj + 0.45:
                    bonds.append(Bond(i, j, 1))
    return [Molecule(atoms=atoms, bonds=bonds, coords=coords)]


def load_molecules(path: str | Path, max_mols: int | None = None) -> list[Molecule]:
    """Read molecules from .sdf/.mol/.mol2/.pdb (optionally .gz)."""
    name = str(path)
    stem = name[:-3] if name.endswith(".gz") else name
    ext = Path(stem).suffix.lower()
    text = _open_text(path)
    if ext in (".sdf", ".mol"):
        return parse_sdf(text, max_mols)
    if ext == ".mol2":
        return parse_mol2(text, max_mols)
    if ext == ".pdb":
        return parse_ligand_pdb(text, max_mols)
    raise ValueError(f"unsupported ligand format: {ext}")
