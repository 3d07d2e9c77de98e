"""Dependency-free PDB reader/writer for the host input pipeline.

Replaces the reference's OpenBabel/Biopython PDB handling
(upstream PharmacoNet src/pmnet/data/extract_pocket.py, objects/objects.py:70-73)
with a small fixed-column parser. Only the records the pipeline needs are
read: first MODEL, ATOM/HETATM, primary altloc.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .periodic import element_to_z


@dataclass
class PDBAtom:
    serial: int
    name: str
    altloc: str
    resname: str
    chain: str
    resseq: int
    icode: str
    x: float
    y: float
    z: float
    element: str
    atomic_num: int
    is_hetatm: bool
    line: str = ""

    @property
    def coords(self) -> tuple[float, float, float]:
        return (self.x, self.y, self.z)


@dataclass
class PDBResidue:
    name: str
    chain: str
    resseq: int
    icode: str
    atoms: list[PDBAtom] = field(default_factory=list)

    @property
    def key(self) -> tuple[str, int, str]:
        return (self.chain, self.resseq, self.icode)

    def atom_by_name(self, name: str) -> PDBAtom | None:
        for atom in self.atoms:
            if atom.name == name:
                return atom
        return None


def _guess_element(name: str, resname: str) -> str:
    """Derive the element from the atom-name columns when 77-78 are blank."""
    stripped = name.strip()
    alpha = "".join(ch for ch in stripped if ch.isalpha())
    if not alpha:
        return ""
    # Two-letter elements occupy column 13 (index 0 of the 4-char field).
    if len(name) >= 2 and name[0] != " " and alpha[:2].upper() in ("FE", "ZN", "MG", "MN", "CL", "BR", "NA", "CA", "SE"):
        return alpha[:2].upper()
    if alpha[0].isdigit():
        return "H"
    return alpha[0].upper()


def parse_pdb(text: str) -> list[PDBResidue]:
    """Parse ATOM/HETATM records of the first model into residues (file order)."""
    residues: list[PDBResidue] = []
    res_index: dict[tuple[str, int, str, str], PDBResidue] = {}
    seen_altloc: dict[tuple, str] = {}

    for line in text.splitlines():
        record = line[:6]
        if record == "ENDMDL":
            break
        if record not in ("ATOM  ", "HETATM"):
            continue
        if len(line) < 54:
            continue
        name = line[12:16]
        altloc = line[16]
        resname = line[17:20].strip()
        chain = line[21]
        try:
            serial = int(line[6:11])
        except ValueError:
            serial = 0
        try:
            resseq = int(line[22:26])
        except ValueError:
            continue
        icode = line[26]
        try:
            x, y, z = float(line[30:38]), float(line[38:46]), float(line[46:54])
        except ValueError:
            continue
        element = line[76:78].strip().upper() if len(line) >= 78 else ""
        if not element or not element.isalpha():
            element = _guess_element(name, resname)

        # keep only the first altloc variant of each atom
        atom_key = (chain, resseq, icode, resname, name.strip())
        if altloc not in (" ", ""):
            prev = seen_altloc.get(atom_key)
            if prev is not None and prev != altloc:
                continue
            seen_altloc[atom_key] = altloc

        atom = PDBAtom(
            serial=serial,
            name=name.strip(),
            altloc=altloc.strip(),
            resname=resname,
            chain=chain,
            resseq=resseq,
            icode=icode,
            x=x,
            y=y,
            z=z,
            element=element,
            atomic_num=element_to_z(element),
            is_hetatm=(record == "HETATM"),
            line=line,
        )
        rkey = (chain, resseq, icode, resname)
        residue = res_index.get(rkey)
        if residue is None:
            residue = PDBResidue(name=resname, chain=chain, resseq=resseq, icode=icode)
            res_index[rkey] = residue
            residues.append(residue)
        residue.atoms.append(atom)
    return residues


def load_pdb(path: str | Path) -> list[PDBResidue]:
    with open(path) as f:
        return parse_pdb(f.read())


def residues_to_pdbblock(residues: list[PDBResidue]) -> str:
    """Re-serialize residues, preserving original record lines when available."""
    lines = []
    for residue in residues:
        for atom in residue.atoms:
            if atom.line:
                lines.append(atom.line)
            else:
                record = "HETATM" if atom.is_hetatm else "ATOM  "
                name = atom.name if len(atom.name) == 4 else f" {atom.name:<3s}"
                lines.append(
                    f"{record}{atom.serial:>5d} {name:<4s}{'':1s}{atom.resname:>3s} "
                    f"{atom.chain}{atom.resseq:>4d}{atom.icode:1s}   "
                    f"{atom.x:8.3f}{atom.y:8.3f}{atom.z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {atom.element:>2s}"
                )
    lines.append("END")
    return "\n".join(lines) + "\n"
