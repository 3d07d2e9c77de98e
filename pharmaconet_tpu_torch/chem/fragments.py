"""Deterministic fragment-enumerated SMILES libraries.

Upstream PharmacoNet screens user-supplied libraries (ZINC et al.,
screening.py:46-75); checks at realistic scale need a reproducible
drug-like library built in-process, with no download. A copy of
`pharmaconet_tpu`'s module: the same (n, seed) gives the same list in both
packages. Molecules are two substituted (hetero)aromatic or saturated
cores joined by a linker:

    core1(sub1) - linker - core2(sub2)

All parts are chosen to exercise every pharmacophore type the scorer
knows (hydrophobic, aromatic, HBD/HBA, cation, anion, halogen; see
chem/ligand_perception.py). Enumeration is a fixed mixed-radix walk +
seeded shuffle, so `enumerate_fragment_smiles(n, seed)` is stable across
runs and machines.

Distinctness: tuples map to distinct SMILES strings (fixed slot
structure); the only molecule-level duplication — swapping the two
(core, substituent) ends across a palindromic linker — is removed by
only emitting tuples with end1 <= end2 for those linkers.
"""

from __future__ import annotations

import itertools
import random

# Core templates. `9` is the ring-closure digit placeholder (rewritten per
# ring so two cores in one molecule never collide), `{s}` the substituent
# branch. Core1 uses the trailing atom as the linker attachment; core2 is
# terminal.
CORES = (
    "c9cc({s})ccc9",    # benzene, para
    "c9c({s})cccc9",    # benzene, ortho
    "c9cc({s})cnc9",    # pyridine
    "c9cc({s})ncc9",    # pyridine, N meta to attachment
    "c9cc({s})oc9",     # furan
    "c9cc({s})sc9",     # thiophene
    "c9cc({s})n(C)c9",  # N-methylpyrrole
    "C9CC({s})CCC9",    # cyclohexane
    "C9CC({s})CCN9",    # piperidine (ring NH: HBD/HBA)
    "C9CC({s})CCO9",    # tetrahydropyran
)

# aryl/alkyl–X–aryl/alkyl linkers; PALINDROMIC ones read the same from
# either end (used for the swap-dedup rule)
LINKERS = (
    "",            # direct biaryl bond
    "C",           # methylene
    "CC",          # ethylene
    "O",           # ether
    "C#C",         # alkyne
    "N(C)",        # N-methyl amine
    "CO",          # -CH2-O-
    "OC",          # -O-CH2-
    "C(=O)N",      # amide ->
    "NC(=O)",      # amide <-
    "S(=O)(=O)N",  # sulfonamide
    "CNC(=O)",     # -CH2-NH-C(=O)-
)
PALINDROMIC_LINKERS = frozenset({"", "C", "CC", "O", "C#C", "N(C)"})

# substituents in branch form (valid inside `(...)` on an aromatic or
# sp3 ring carbon)
SUBSTITUENTS = (
    "F", "Cl", "Br", "I",              # halogens (XBond donors)
    "C", "CC", "C(C)C", "C(F)(F)F",    # hydrophobic
    "O", "OC", "CO",                   # hydroxyl / methoxy / hydroxymethyl
    "N", "NC", "C#N",                  # amine / methylamine / nitrile
    "C(=O)O", "C(=O)OC", "C(=O)N",     # acid / ester / amide
    "NC(=O)C",                         # acetamido
    "S(=O)(=O)N",                      # sulfonamide
    "[N+](=O)[O-]",                    # nitro
    "[N+](C)(C)C",                     # quaternary ammonium (cation)
    "C(=O)[O-]", "S(=O)(=O)[O-]",      # carboxylate / sulfonate (anions)
)


def _assemble(c1: int, s1: int, lk: int, c2: int, s2: int) -> str:
    left = CORES[c1].replace("9", "1").format(s=SUBSTITUENTS[s1])
    right = CORES[c2].replace("9", "2").format(s=SUBSTITUENTS[s2])
    return left + LINKERS[lk] + right


def iter_fragment_space():
    """Yield every deduplicated (c1, s1, lk, c2, s2) tuple in a fixed
    order. Swap-symmetric duplicates across palindromic linkers are
    skipped (end1 <= end2 rule)."""
    nc, ns = len(CORES), len(SUBSTITUENTS)
    for lk in range(len(LINKERS)):
        pal = LINKERS[lk] in PALINDROMIC_LINKERS
        for c1, s1 in itertools.product(range(nc), range(ns)):
            for c2, s2 in itertools.product(range(nc), range(ns)):
                if pal and (c1, s1) > (c2, s2):
                    continue
                yield c1, s1, lk, c2, s2


def fragment_space_size() -> int:
    nc, ns = len(CORES), len(SUBSTITUENTS)
    ends = nc * ns
    pal = sum(1 for l in LINKERS if l in PALINDROMIC_LINKERS)
    dire = len(LINKERS) - pal
    return dire * ends * ends + pal * ends * (ends + 1) // 2


def enumerate_fragment_smiles(
    n: int, seed: int = 0
) -> list[tuple[str, str]]:
    """`n` distinct (name, smiles) entries, deterministically sampled
    from the deduplicated fragment space (seeded shuffle of the full
    tuple walk)."""
    total = fragment_space_size()
    if n > total:
        raise ValueError(f"n={n} exceeds fragment space {total}")
    tuples = list(iter_fragment_space())
    assert len(tuples) == total
    random.Random(seed).shuffle(tuples)
    out = []
    seen: set[str] = set()
    for tup in tuples:
        smi = _assemble(*tup)
        if smi in seen:  # defensive; slot structure should prevent this
            continue
        seen.add(smi)
        out.append((f"frag{len(out):06d}", smi))
        if len(out) == n:
            return out
    raise RuntimeError("fragment space exhausted below n after dedup")
