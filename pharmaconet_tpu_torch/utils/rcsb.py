"""RCSB PDB download + ligand detection.

A copy of `pharmaconet_tpu`'s `utils/rcsb.py`: upstream
utils/parse_rcsb_pdb.py:39-140 without PyMOL or OpenBabel. HET/HETNAM/HETSYN
header records are parsed directly from the PDB text and each detected
ligand is written to its own PDB file with the in-house parser (upstream
uses a PyMOL selection for this). `download_pdb` returns False when the
fetch fails.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..chem.pdb import parse_pdb as parse_pdb_text

PathLike = str | Path


@dataclass
class LigandInform:
    order: int
    id: str
    pdbchain: str
    authchain: str
    residx: int
    center: tuple[float, float, float]
    file_path: PathLike
    name: str | None
    synonyms: str | None

    def __str__(self) -> str:
        x, y, z = self.center
        string = (
            f"Ligand {self.order}\n"
            f"- ID      : {self.id} (Chain: {self.pdbchain} [auth {self.authchain}])\n"
            f"- Center  : {x:.3f}, {y:.3f}, {z:.3f}"
        )
        if self.name is not None:
            string += f"\n- Name    : {self.name}"
        if self.synonyms is not None:
            string += f"\n- Synonyms: {self.synonyms}"
        return string


def download_pdb(pdb_code: str, output_file: PathLike) -> bool:
    """Fetch a PDB entry from RCSB; returns False on failure (no egress)."""
    from urllib.request import urlopen

    url = f"https://files.rcsb.org/download/{pdb_code.lower()}.pdb"
    try:
        with urlopen(url, timeout=30) as response:
            content = response.read().decode("utf-8")
        with open(output_file, "w") as f:
            f.write(content)
        return True
    except Exception as e:  # pragma: no cover - network dependent
        print(f"Error downloading PDB file: {e}")
        return False


def _parse_het_names(lines: list[str], record: str) -> dict[str, str]:
    """Accumulate HETNAM/HETSYN continuation records into {het_id: text}."""
    out: dict[str, str] = {}
    for line in lines:
        if not line.startswith(record):
            continue
        body = line[len(record):].rstrip()
        fields = body.split()
        if not fields:
            continue
        # continuation lines start with a continuation number
        if fields[0].isdigit() and len(fields) >= 2:
            key = fields[1]
            text = " ".join(fields[2:])
            if key in out:
                if out[key].endswith("-"):
                    out[key] += text
                else:
                    out[key] += " " + text
                continue
        key = fields[0]
        out[key] = " ".join(fields[1:])
    return out


def parse_pdb(pdb_code: str, protein_path: PathLike, save_dir: PathLike) -> list[LigandInform]:
    """Detect HET ligands, write each to ``save_dir``, compute centers."""
    with open(protein_path) as f:
        text = f.read()
    lines = text.splitlines()

    het_records = []
    for line in lines:
        if line.startswith("HET "):
            fields = line[4:].split()
            if len(fields) >= 3:
                het_id = fields[0]
                if len(fields[1]) > 1 and not fields[1].isdigit():
                    chain, resi = fields[1][0], fields[1][1:]
                else:
                    chain, resi = fields[1], fields[2]
                try:
                    het_records.append((het_id, chain, int(resi)))
                except ValueError:
                    continue
    if not het_records:
        return []

    names = _parse_het_names(lines, "HETNAM")
    synonyms = _parse_het_names(lines, "HETSYN")

    residues = parse_pdb_text(text)
    res_index = {}
    for residue in residues:
        res_index[(residue.name, residue.chain, residue.resseq)] = residue

    last_chain = max((r.chain for r in residues if not r.atoms[0].is_hetatm), default="A")

    informs: list[LigandInform] = []
    os.makedirs(save_dir, exist_ok=True)
    for idx, (het_id, authchain, residx) in enumerate(het_records):
        residue = res_index.get((het_id, authchain, residx))
        if residue is None or het_id == "HOH":
            continue
        pdbchain = chr(ord(last_chain) + idx + 1)
        identify_key = f"{pdb_code}_{pdbchain}_{het_id}"
        ligand_path = os.path.join(str(save_dir), f"{identify_key}.pdb")
        if not os.path.exists(ligand_path):
            with open(ligand_path, "w") as w:
                for atom in residue.atoms:
                    w.write(atom.line + "\n")
                w.write("END\n")
        heavy = [a for a in residue.atoms if a.atomic_num not in (0, 1)]
        center = np.mean([a.coords for a in heavy], axis=0)
        informs.append(
            LigandInform(
                order=idx + 1,
                id=het_id,
                pdbchain=pdbchain,
                authchain=authchain,
                residx=residx,
                center=(float(center[0]), float(center[1]), float(center[2])),
                file_path=ligand_path,
                name=names.get(het_id),
                synonyms=synonyms.get(het_id),
            )
        )
    return informs
