"""Amino-acid residue templates: heavy-atom adjacency and chemical roles.

A frozen copy of the program's `chem/templates.py`, so that what the
benchmark writes (`pocketgen.py`) and how its reference perceives a
pocket (`detector_reference.py`) stay what they are whatever a later
change does to the program. The table follows upstream PharmacoNet's
OpenBabel perception (src/pmnet/data/objects/objects.py:76-141):

  * ``bonds``      - intra-residue heavy-atom bonds (backbone N-CA-C=O implied)
  * ``rings``      - 5/6-membered aromatic rings (only TYR/TRP/HIS/PHE emit
                     ring tokens)
  * ``donors``     - heavy atoms carrying a polar hydrogen
  * ``acceptors``  - H-bond acceptor heavy atoms
  * ``pos``/``neg``- charged side-chain atoms (side-chain N of ARG/HIS/LYS;
                     side-chain O of GLU/ASP)

Departures from OpenBabel kept from the program: LYS NZ and the ARG
guanidinium N are no acceptors; HIS ND1/NE2 are both donor and acceptor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Final

BACKBONE_BONDS: Final[tuple[tuple[str, str], ...]] = (("N", "CA"), ("CA", "C"), ("C", "O"), ("C", "OXT"))

# Residues whose rings emit aromatic tokens (objects.py:100)
RING_RESIDUES: Final[frozenset[str]] = frozenset({"TYR", "TRP", "HIS", "PHE"})

# Pocket-extraction residue whitelist (reference: extract_pocket.py:13-58)
POCKET_AMINO_ACIDS: Final[frozenset[str]] = frozenset({
    "GLY", "ALA", "VAL", "LEU", "ILE", "PRO", "PHE", "TYR", "TRP", "SER",
    "THR", "CYS", "MET", "ASN", "GLN", "ASP", "GLU", "LYS", "ARG", "HIS",
    "HIP", "HIE", "TPO", "HID", "LEV", "MEU", "PTR", "GLV", "CYT", "SEP",
    "HIZ", "CYM", "GLM", "ASQ", "TYS", "CYX", "GLZ", "MSE", "CSO", "KCX",
    "CSD", "MLY", "PCA", "LLP",
})


@dataclass(frozen=True)
class ResidueTemplate:
    name: str
    sidechain_bonds: tuple[tuple[str, str], ...] = ()
    rings: tuple[tuple[str, ...], ...] = ()
    donors: frozenset[str] = field(default_factory=frozenset)
    acceptors: frozenset[str] = field(default_factory=frozenset)
    pos_charged: tuple[str, ...] = ()
    neg_charged: tuple[str, ...] = ()

    @property
    def bonds(self) -> tuple[tuple[str, str], ...]:
        return BACKBONE_BONDS + self.sidechain_bonds


def _t(name, bonds=(), rings=(), donors=(), acceptors=(), pos=(), neg=()):
    return ResidueTemplate(
        name=name,
        sidechain_bonds=tuple(bonds),
        rings=tuple(tuple(r) for r in rings),
        donors=frozenset(donors),
        acceptors=frozenset(acceptors),
        pos_charged=tuple(pos),
        neg_charged=tuple(neg),
    )


_PHE_RING = ("CG", "CD1", "CD2", "CE1", "CE2", "CZ")
_TRP_RING5 = ("CG", "CD1", "NE1", "CE2", "CD2")
_TRP_RING6 = ("CD2", "CE2", "CZ2", "CH2", "CZ3", "CE3")
_HIS_RING = ("CG", "ND1", "CD2", "CE1", "NE2")

RESIDUE_TEMPLATES: Final[dict[str, ResidueTemplate]] = {
    "GLY": _t("GLY"),
    "ALA": _t("ALA", [("CA", "CB")]),
    "VAL": _t("VAL", [("CA", "CB"), ("CB", "CG1"), ("CB", "CG2")]),
    "LEU": _t("LEU", [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2")]),
    "ILE": _t("ILE", [("CA", "CB"), ("CB", "CG1"), ("CB", "CG2"), ("CG1", "CD1")]),
    "PRO": _t("PRO", [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "N")]),
    "PHE": _t(
        "PHE",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
         ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ")],
        rings=[_PHE_RING],
    ),
    "TYR": _t(
        "TYR",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
         ("CD1", "CE1"), ("CD2", "CE2"), ("CE1", "CZ"), ("CE2", "CZ"), ("CZ", "OH")],
        rings=[_PHE_RING],
        donors=["OH"],
        acceptors=["OH"],
    ),
    "TRP": _t(
        "TRP",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD1"), ("CG", "CD2"),
         ("CD1", "NE1"), ("NE1", "CE2"), ("CE2", "CD2"), ("CD2", "CE3"),
         ("CE2", "CZ2"), ("CE3", "CZ3"), ("CZ2", "CH2"), ("CZ3", "CH2")],
        rings=[_TRP_RING5, _TRP_RING6],
        donors=["NE1"],
    ),
    "SER": _t("SER", [("CA", "CB"), ("CB", "OG")], donors=["OG"], acceptors=["OG"]),
    "THR": _t("THR", [("CA", "CB"), ("CB", "OG1"), ("CB", "CG2")], donors=["OG1"], acceptors=["OG1"]),
    "CYS": _t("CYS", [("CA", "CB"), ("CB", "SG")], donors=["SG"]),
    "MET": _t("MET", [("CA", "CB"), ("CB", "CG"), ("CG", "SD"), ("SD", "CE")]),
    "ASN": _t(
        "ASN",
        [("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "ND2")],
        donors=["ND2"],
        acceptors=["OD1"],
    ),
    "GLN": _t(
        "GLN",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "NE2")],
        donors=["NE2"],
        acceptors=["OE1"],
    ),
    "ASP": _t(
        "ASP",
        [("CA", "CB"), ("CB", "CG"), ("CG", "OD1"), ("CG", "OD2")],
        acceptors=["OD1", "OD2"],
        neg=["OD1", "OD2"],
    ),
    "GLU": _t(
        "GLU",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "OE1"), ("CD", "OE2")],
        acceptors=["OE1", "OE2"],
        neg=["OE1", "OE2"],
    ),
    "LYS": _t(
        "LYS",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "CE"), ("CE", "NZ")],
        donors=["NZ"],
        pos=["NZ"],
    ),
    "ARG": _t(
        "ARG",
        [("CA", "CB"), ("CB", "CG"), ("CG", "CD"), ("CD", "NE"),
         ("NE", "CZ"), ("CZ", "NH1"), ("CZ", "NH2")],
        donors=["NE", "NH1", "NH2"],
        pos=["NE", "NH1", "NH2"],
    ),
    "HIS": _t(
        "HIS",
        [("CA", "CB"), ("CB", "CG"), ("CG", "ND1"), ("CG", "CD2"),
         ("ND1", "CE1"), ("CE1", "NE2"), ("NE2", "CD2")],
        rings=[_HIS_RING],
        donors=["ND1", "NE2"],
        acceptors=["ND1", "NE2"],
        pos=["ND1", "NE2"],
    ),
}

# Common non-standard residues mapped onto standard chemistry.
_MSE = RESIDUE_TEMPLATES["MET"]
RESIDUE_TEMPLATES["MSE"] = ResidueTemplate(
    name="MSE",
    sidechain_bonds=tuple(
        (a.replace("SD", "SE"), b.replace("SD", "SE")) for a, b in _MSE.sidechain_bonds
    ),
)
for _alias, _base in (
    ("HID", "HIS"), ("HIE", "HIS"), ("HIP", "HIS"), ("HIZ", "HIS"),
    ("CYX", "CYS"), ("CYM", "CYS"), ("CYT", "CYS"),
    ("ASQ", "ASP"), ("GLM", "GLU"), ("GLV", "GLU"), ("GLZ", "GLU"),
    ("LEV", "LEU"), ("MEU", "MET"), ("TYS", "TYR"),
):
    _b = RESIDUE_TEMPLATES[_base]
    RESIDUE_TEMPLATES[_alias] = ResidueTemplate(
        name=_alias,
        sidechain_bonds=_b.sidechain_bonds,
        rings=_b.rings,
        donors=_b.donors,
        acceptors=_b.acceptors,
        pos_charged=_b.pos_charged,
        neg_charged=_b.neg_charged,
    )

# Backbone roles shared by every residue:
#   * N is a donor except in PRO (no H on N)
#   * O (and OXT) are acceptors
BACKBONE_DONOR: Final[str] = "N"
BACKBONE_ACCEPTORS: Final[tuple[str, ...]] = ("O", "OXT")
