"""Minimal periodic-table data used by the host chemistry layer.

The reference delegates element handling to OpenBabel; this rebuild keeps the
host chemistry dependency-free (plain Python + numpy).
"""

from __future__ import annotations

from typing import Final

SYMBOL_TO_Z: Final[dict[str, int]] = {
    "H": 1, "HE": 2, "LI": 3, "BE": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "NE": 10, "NA": 11, "MG": 12, "AL": 13, "SI": 14, "P": 15, "S": 16,
    "CL": 17, "AR": 18, "K": 19, "CA": 20, "MN": 25, "FE": 26, "CO": 27,
    "NI": 28, "CU": 29, "ZN": 30, "GA": 31, "GE": 32, "AS": 33, "SE": 34,
    "BR": 35, "KR": 36, "RB": 37, "SR": 38, "MO": 42, "RU": 44, "RH": 45,
    "PD": 46, "AG": 47, "CD": 48, "IN": 49, "SN": 50, "SB": 51, "TE": 52,
    "I": 53, "XE": 54, "CS": 55, "BA": 56, "W": 74, "RE": 75, "OS": 76,
    "IR": 77, "PT": 78, "AU": 79, "HG": 80, "TL": 81, "PB": 82, "BI": 83,
}

Z_TO_SYMBOL: Final[dict[int, str]] = {z: s.capitalize() for s, z in SYMBOL_TO_Z.items()}

HALOGENS: Final[frozenset[int]] = frozenset({9, 17, 35, 53})

# Default valences for implicit-hydrogen inference on ligand atoms
# (neutral-atom octet valences; charge adjustments applied separately).
DEFAULT_VALENCE: Final[dict[int, int]] = {
    1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 3, 16: 2,
    17: 1, 35: 1, 53: 1,
}

# Covalent radii (Angstrom) for geometric bond perception fallbacks.
COVALENT_RADIUS: Final[dict[int, float]] = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 11: 1.66,
    12: 1.41, 14: 1.11, 15: 1.07, 16: 1.05, 17: 1.02, 19: 2.03, 20: 1.76,
    25: 1.39, 26: 1.32, 29: 1.32, 30: 1.22, 34: 1.20, 35: 1.20, 53: 1.39,
}


def element_to_z(symbol: str) -> int:
    """Return the atomic number for an element symbol (0 if unknown)."""
    return SYMBOL_TO_Z.get(symbol.strip().upper(), 0)
