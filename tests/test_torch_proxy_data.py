"""The port's proxy featurization (`pharmaconet_tpu_torch.proxy.data`) and
cache key lists against the JAX package's.

Everything here is exact: graph arrays and padded batches element-equal
(same dtypes), `None` at the same invalid SMILES, key lists equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pharmaconet_tpu.proxy import data as jdata
from pharmaconet_tpu.proxy.base import load_cache_keys as jax_load_cache_keys
from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
from pharmaconet_tpu_torch.proxy import data
from pharmaconet_tpu_torch.proxy.base import load_cache_keys


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores, and 8 threads a worker made these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fragments(n: int, seed: int) -> list[str]:
    return [smi for _, smi in enumerate_fragment_smiles(n, seed=seed)]


# aromatic and charged atoms, chirality, rings, halogens, explicit H and an
# exotic element (the C++ parser's status 2: the Python parser takes them),
# and malformed SMILES
SMILES = ["CCO", "c1ccccc1O", "N[C@@H](C)C(=O)[O-]", "C[C@H](F)Cl", "c1ccncc1Br",
          "O=S(=O)(N)c1ccc(I)cc1", "C#N", "[NH4+]", "[2H]C([2H])([2H])O", "[Se]1C=CC=C1",
          "P(=O)(O)(O)O", "C1CC1C2CC2", "c11", "C(", "", "CC(C)(C)C(=O)N[C@@H](Cc1ccccc1)C"]
FIELDS = ("atom_class", "atom_features", "edge_src", "edge_dst", "edge_class",
          "edge_features")


def _assert_graph_equal(got, want):
    if want is None:
        assert got is None
        return
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("smi", [s for s in SMILES if s not in ("c11", "C(", "")])
def test_smi2graph_matches_jax(smi):
    _assert_graph_equal(data.smi2graph(smi), jdata.smi2graph(smi))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_smi2graph_list_matches_jax(native):
    fragments = _fragments(64, 11)
    smiles = SMILES + fragments
    got = data.smi2graph_list(smiles, native=native)
    want = jdata.smi2graph_list(smiles, native=native)
    assert [g is None for g in got] == [g is None for g in want]
    assert [g is None for g in got[: len(SMILES)]] == [
        s in ("c11", "C(") or (s == "" and native) for s in SMILES]
    for a, b in zip(got, want):
        _assert_graph_equal(a, b)


def test_native_and_python_parsers_agree():
    """Element-equal graphs, except for the empty SMILES: the C++ parser
    calls it invalid (None), the Python parser an empty graph, in both
    packages alike."""
    smiles = [s for s in SMILES if s] + _fragments(256, 3)
    for a, b in zip(data.smi2graph_list(smiles), data.smi2graph_list(smiles, native=False)):
        _assert_graph_equal(a, b)


@pytest.mark.parametrize("kw", [{}, dict(pad_multiple=8), dict(num_graphs_pad=16),
                                dict(num_atoms_pad=512, num_edges_pad=640)],
                         ids=["default", "pad8", "graph-pad", "atom-edge-pad"])
def test_batch_graphs_matches_jax(kw):
    smiles = [s for s in SMILES if s not in ("c11", "C(", "")]
    graphs = data.smi2graph_list(smiles)
    got = data.batch_graphs(graphs, **kw)
    want = jdata.batch_graphs(jdata.smi2graph_list(smiles), **kw)
    assert got.num_graphs == want.num_graphs
    for name in ("atom_class", "atom_features", "atom_graph", "atom_valid", "edge_src",
                 "edge_dst", "edge_class", "edge_features", "edge_valid", "num_atoms"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # segment layout: graph ids ascending, padding atoms in the sentinel
    assert (np.diff(got.atom_graph) >= 0).all()
    assert (got.atom_graph[~got.atom_valid] == got.num_graphs).all()


@pytest.mark.parametrize("n", [1, 7, 8, 9, 13, 100, 2048])
def test_half_octave_matches_jax(n):
    assert data.half_octave(n) == jdata.half_octave(n)


@pytest.mark.parametrize("variant", ["base", "tacogfn"])
def test_cache_keys_match_jax(variant):
    for dataset in ("train", "test"):
        assert load_cache_keys(dataset, variant) == jax_load_cache_keys(dataset, variant)
    assert len(load_cache_keys("train", variant)) == {"base": 15201, "tacogfn": 15207}[variant]
    with pytest.raises(ValueError):
        load_cache_keys("valid")


def test_failed_native_build_raises(monkeypatch):
    """The default path needs the C++ parser: a build failure raises, it
    does not fall back to the Python parser."""
    from pharmaconet_tpu_torch import native

    def broken(*a, **k):
        raise RuntimeError("build of smi_graph failed")

    monkeypatch.setattr(native, "build_shared", broken)
    monkeypatch.setattr(native, "_state", {})
    with pytest.raises(RuntimeError, match="smi_graph"):
        data.smi2graph_list(["CCO"])
    assert data.smi2graph_list(["CCO"], native=False)[0].num_atoms == 3
