"""The port's SMILES input against the JAX package's: the parser, the
SMILES file reader and the fragment libraries.

`pharmaconet_tpu_torch.chem.smiles` and `.fragments` are copies of the JAX
package's JAX-free modules; the same string must give the same atoms,
charges, aromatic flags, H counts and bonds, the same errors, and the same
fragment lists in both packages.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from pharmaconet_tpu.chem import fragments as j_frag
from pharmaconet_tpu.chem.smiles import SmilesError as JSmilesError
from pharmaconet_tpu.chem.smiles import parse_smiles as j_parse
from pharmaconet_tpu.scoring.library import read_smiles_file as j_read
from pharmaconet_tpu_torch.chem import fragments as t_frag
from pharmaconet_tpu_torch.chem.smiles import SmilesError, parse_smiles
from pharmaconet_tpu_torch.scoring.library import read_smiles_file
from test_chem_golden import CORPUS
from test_embed import PANEL

CASES = {**{f"panel:{k}": v for k, v in PANEL.items()},
         **{f"corpus:{k}": v[0] for k, v in CORPUS.items()},
         "explicit-h": "[H]OC([H])([H])C", "charged": "C[N+](C)(C)C.[O-]C(=O)C",
         "isotope-chiral": "[13CH3][C@@H](N)C(=O)O", "percent-ring": "C%10CCCCC%10",
         "dot-fragments": "CC.O", "triple": "N#Cc1ccccc1"}


def _summary(mol):
    atoms = [dataclasses.astuple(a) for a in mol.atoms]
    bonds = [dataclasses.astuple(b) for b in mol.bonds]
    return atoms, bonds, mol.title


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_smiles_matches_jax(name):
    smi = CASES[name]
    got, want = parse_smiles(smi), j_parse(smi)
    assert _summary(got) == _summary(want)
    assert got.num_atoms > 0
    stripped, j_stripped = got.strip_hydrogens(), want.strip_hydrogens()
    assert _summary(stripped) == _summary(j_stripped)
    assert [a.h_count for a in stripped.atoms] == [a.h_count for a in j_stripped.atoms]


@pytest.mark.parametrize("bad", ["C(", "C)", "C1CC", "[CH3", "C%1", "1CC", "C11",
                                 "(C)", "[Xx]", "C$$$?", "[C@@H"])
def test_smiles_errors_match_jax(bad):
    with pytest.raises(SmilesError) as got:
        parse_smiles(bad)
    with pytest.raises(JSmilesError) as want:
        j_parse(bad)
    assert str(got.value) == str(want.value)


def test_garbage_fails_only_with_smiles_error():
    """Random strings parse the same in both packages or fail with the
    same SmilesError message: the tolerant library paths rely on it."""
    rng = random.Random(0)
    alphabet = list("CcNnOoSsPpBFIl()[]=#-+@H123456789%./\\rb")
    parsed = 0
    for _ in range(1000):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 14)))
        try:
            want = _summary(j_parse(s))
        except JSmilesError as e:
            with pytest.raises(SmilesError) as got:
                parse_smiles(s)
            assert str(got.value) == str(e)
            continue
        assert _summary(parse_smiles(s)) == want
        parsed += 1
    assert parsed > 20


def test_read_smiles_file_comments(tmp_path):
    f = tmp_path / "lib.smi"
    f.write_text("CCO ethanol\n# full-line comment\n\n"
                 "c1ccccc1,benzene  # trailing comment\nCC(=O)O\n")
    want = [("ethanol", "CCO"), ("benzene", "c1ccccc1"), ("mol2", "CC(=O)O")]
    assert read_smiles_file(f) == j_read(f) == want


def test_read_smiles_file_triple_bond_not_comment(tmp_path):
    f = tmp_path / "lib.smi"
    f.write_text("C#N acetonitrile\nN#Cc1ccccc1 benzonitrile # nitriles\nC#C\n")
    want = [("acetonitrile", "C#N"), ("benzonitrile", "N#Cc1ccccc1"), ("mol2", "C#C")]
    assert read_smiles_file(f) == j_read(f) == want


@pytest.mark.parametrize("n,seed", [(16, 23), (64, 11), (2048, 11), (300, 0)])
def test_fragment_lists_match_jax(n, seed):
    got = t_frag.enumerate_fragment_smiles(n, seed=seed)
    assert got == j_frag.enumerate_fragment_smiles(n, seed=seed)
    assert len(got) == n and len({s for _, s in got}) == n


def test_fragment_space_matches_jax():
    assert t_frag.fragment_space_size() == j_frag.fragment_space_size()
    assert list(t_frag.iter_fragment_space()) == list(j_frag.iter_fragment_space())
    for name, smi in t_frag.enumerate_fragment_smiles(64, seed=5):
        assert parse_smiles(smi).num_atoms > 0, name
