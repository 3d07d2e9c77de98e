"""Host chemistry layer: dependency-free SDF/MOL2 parsing and ligand
pharmacophore perception (the part screening's live route needs)."""

from .ligand_perception import PharmacophoreNode, get_pharmacophore_nodes
from .smallmol import Molecule, load_molecules, parse_mol2, parse_sdf

__all__ = [
    "PharmacophoreNode",
    "get_pharmacophore_nodes",
    "Molecule",
    "load_molecules",
    "parse_mol2",
    "parse_sdf",
]
