"""Host chemistry layer: dependency-free PDB/SDF/MOL2 parsing and perception.

This is the input pipeline, not the compute path: it runs on the host CPU
and feeds fixed-shape arrays to the programs on the card. SMILES parsing
(`smiles`), fragment libraries (`fragments`) and conformer embedding
(`embed`, whose torch backend runs on the card) are imported from their
modules, as in `pharmaconet_tpu`.
"""

from .ligand_perception import PharmacophoreNode, get_pharmacophore_nodes
from .pdb import PDBAtom, PDBResidue, load_pdb, parse_pdb, residues_to_pdbblock
from .pocket import extract_pocket, extract_pocket_residues
from .protein import Protein
from .smallmol import Molecule, load_molecules, parse_mol2, parse_sdf

__all__ = [
    "PharmacophoreNode",
    "get_pharmacophore_nodes",
    "PDBAtom",
    "PDBResidue",
    "load_pdb",
    "parse_pdb",
    "residues_to_pdbblock",
    "extract_pocket",
    "extract_pocket_residues",
    "Protein",
    "Molecule",
    "load_molecules",
    "parse_mol2",
    "parse_sdf",
]
