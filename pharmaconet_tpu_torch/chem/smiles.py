"""Minimal SMILES reader producing the in-house ``Molecule`` model.

Upstream PharmacoNet's proxies parse SMILES with OpenBabel
(pmnet_appl/*/data.py); this package needs neither OpenBabel nor RDKit, so
a self-contained parser (a copy of `pharmaconet_tpu`'s) covers the needed
subset:

  * organic-subset atoms (B C N O P S F Cl Br I) and bracket atoms with
    isotope/charge/explicit-H/chirality (@ / @@ recorded as ccw/cw flags)
  * aromatic atoms (lowercase) and bonds; ':' aromatic bond
  * bonds - = # $ /, \\ (stereo bonds read as single)
  * branches, ring closures (digits and %nn), dot-separated fragments

No kekulization is attempted: aromatic bonds carry order 4 with the
aromatic flag, matching how the proxy featurizers bin them (pmnet_appl/
tacogfn_reward/data.py:19-25: aromatic -> class 3).
"""

from __future__ import annotations

from dataclasses import dataclass

from .periodic import element_to_z
from .smallmol import Atom, Bond, Molecule

ORGANIC_TWO = ("Cl", "Br")
ORGANIC_ONE = set("BCNOPSFI")
AROMATIC_ONE = set("bcnops")

AROMATIC_DEFAULT_VALENCE = {5: 3, 6: 4, 7: 3, 8: 2, 15: 3, 16: 2}


@dataclass
class _ParserAtom(Atom):
    explicit_h: int | None = None
    chirality: int = 0  # 0 none, 1 = @ (ccw), 2 = @@ (cw)


@dataclass
class _RingBond:
    atom: int
    order: int | None


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str) -> Molecule:
    atoms: list[_ParserAtom] = []
    bonds: list[Bond] = []
    stack: list[int] = []
    prev: int | None = None
    pending_order: int | None = None
    ring_bonds: dict[int, _RingBond] = {}

    i = 0
    n = len(smiles)

    def add_bond(a: int, b: int, order: int | None):
        if order is None:
            aromatic = atoms[a].aromatic and atoms[b].aromatic
            order = 4 if aromatic else 1
        bonds.append(Bond(a, b, order, aromatic=(order == 4)))

    def add_atom(z: int, aromatic: bool, charge: int = 0,
                 explicit_h: int | None = None, chirality: int = 0) -> int:
        atoms.append(
            _ParserAtom(
                atomic_num=z, charge=charge, aromatic=aromatic,
                explicit_h=explicit_h, chirality=chirality,
            )
        )
        return len(atoms) - 1

    while i < n:
        ch = smiles[i]
        if ch == "(":
            if prev is None:
                raise SmilesError("branch with no previous atom")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError("unbalanced parentheses")
            prev = stack.pop()
            i += 1
        elif ch == ".":
            prev = None
            i += 1
        elif ch in "-=#$:/\\":
            pending_order = {"-": 1, "=": 2, "#": 3, "$": 4, ":": 4, "/": 1, "\\": 1}[ch]
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                if i + 2 >= n or not smiles[i + 1 : i + 3].isdigit():
                    raise SmilesError("bad %nn ring closure")
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(ch)
                i += 1
            if prev is None:
                raise SmilesError("ring closure with no previous atom")
            if num in ring_bonds:
                partner = ring_bonds.pop(num)
                if partner.atom == prev:
                    raise SmilesError(f"ring closure {num} bonds an atom to itself")
                order = pending_order if pending_order is not None else partner.order
                add_bond(partner.atom, prev, order)
            else:
                ring_bonds[num] = _RingBond(prev, pending_order)
            pending_order = None
        elif ch == "[":
            end = smiles.find("]", i)
            if end < 0:
                raise SmilesError("unterminated bracket atom")
            idx = _parse_bracket(smiles[i + 1 : end], add_atom)
            if prev is not None:
                add_bond(prev, idx, pending_order)
            pending_order = None
            prev = idx
            i = end + 1
        else:
            # organic subset atom
            two = smiles[i : i + 2]
            if two in ORGANIC_TWO:
                idx = add_atom(element_to_z(two), aromatic=False)
                i += 2
            elif ch in ORGANIC_ONE:
                idx = add_atom(element_to_z(ch), aromatic=False)
                i += 1
            elif ch in AROMATIC_ONE:
                idx = add_atom(element_to_z(ch.upper()), aromatic=True)
                i += 1
            else:
                raise SmilesError(f"unexpected character {ch!r} at {i} in {smiles!r}")
            if prev is not None:
                add_bond(prev, idx, pending_order)
            pending_order = None
            prev = idx

    if ring_bonds:
        raise SmilesError(f"unclosed ring bonds: {sorted(ring_bonds)}")
    if stack:
        raise SmilesError("unbalanced parentheses")

    mol = Molecule(atoms=list(atoms), bonds=bonds, coords=None)
    _assign_h_counts(mol)
    return mol


def _parse_bracket(body: str, add_atom) -> int:
    i = 0
    n = len(body)
    # isotope
    while i < n and body[i].isdigit():
        i += 1
    if i >= n:
        raise SmilesError(f"bad bracket atom [{body}]")
    # element (possibly aromatic lowercase)
    aromatic = False
    if body[i].islower() and body[i] in "bcnops" and (i + 1 >= n or not body[i + 1].islower()):
        symbol = body[i].upper()
        aromatic = True
        i += 1
    else:
        symbol = body[i]
        i += 1
        if i < n and body[i].islower():
            symbol += body[i]
            i += 1
    z = element_to_z(symbol)
    if z == 0:
        raise SmilesError(f"unknown element {symbol!r}")
    # chirality
    chirality = 0
    if i < n and body[i] == "@":
        chirality = 1
        i += 1
        if i < n and body[i] == "@":
            chirality = 2
            i += 1
        # ignore named chirality classes (@TH1 etc.)
        while i < n and body[i].isalnum() and body[i] not in "H+-":
            if body[i] == "H":
                break
            i += 1
    # explicit hydrogens
    explicit_h = 0
    if i < n and body[i] == "H":
        i += 1
        count = ""
        while i < n and body[i].isdigit():
            count += body[i]
            i += 1
        explicit_h = int(count) if count else 1
    # charge
    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        count = ""
        while i < n and body[i].isdigit():
            count += body[i]
            i += 1
        charge += sign * (int(count) if count else 1)
    return add_atom(z, aromatic, charge, explicit_h, chirality)


def _assign_h_counts(mol: Molecule) -> None:
    """Fill Atom.h_count from explicit bracket H or implicit valence."""
    from .periodic import DEFAULT_VALENCE

    for i, atom in enumerate(mol.atoms):
        explicit = getattr(atom, "explicit_h", None)
        if explicit is not None:
            atom.h_count = explicit
            continue
        z = atom.atomic_num
        if atom.aromatic:
            valence = AROMATIC_DEFAULT_VALENCE.get(z)
            if valence is None:
                atom.h_count = 0
                continue
            order_sum = 0.0
            for b in mol.bonds_of(i):
                order_sum += 1.5 if (b.aromatic or b.order == 4) else b.order
            # aromatic C with 2 ring bonds: 4 - 3 = 1 H; N in pyridine: 0
            import math

            h = valence + atom.charge - math.ceil(order_sum)
            atom.h_count = max(0, int(h))
        else:
            valence = DEFAULT_VALENCE.get(z)
            if valence is None:
                atom.h_count = 0
                continue
            order_sum = sum(
                {1: 1, 2: 2, 3: 3, 4: 1.5, 5: 1}[b.order] for b in mol.bonds_of(i)
            )
            import math

            atom.h_count = max(0, int(valence + atom.charge - math.ceil(order_sum)))
