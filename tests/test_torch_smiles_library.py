"""SMILES libraries through the port's CLIs and API against the JAX
package's.

- `prepack --smiles --embed_backend numpy` writes an .npz array-equal to
  the JAX CLI's (the numpy embedder is a copy of the JAX package's, PCG
  streams and all), in one process and in two spawned workers.
- `screening --smiles --device cpu` writes the JAX CLI's CSV within
  rtol 2e-5 / atol 1e-4.
- `prepack --smiles --tiles_out` composes with `screening --library_tiles`.
- `scoring_smiles(..., conformer_engine="dg")` scores equal in both.
- A library embedded by the port's torch backend (on the CPU here) screens
  equal in both packages.
- Both CLIs raise on `--device cuda` without a card.
"""

from __future__ import annotations

import importlib.util

import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.cli.prepack import build_parser as j_prepack_parser
from pharmaconet_tpu.cli.prepack import main as j_prepack_main
from pharmaconet_tpu.cli.screening import build_parser as j_screen_parser
from pharmaconet_tpu.cli.screening import main as j_screen_main
from pharmaconet_tpu.pharmacophore.model import PharmacophoreModel as JModel
from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
from pharmaconet_tpu_torch.cli import prepack as t_prepack
from pharmaconet_tpu_torch.cli import screening as t_screen
from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel as TModel
from pharmaconet_tpu_torch.scoring.library import build_library_from_smiles, save_library
from test_torch_cli_screening import _assert_csv_close, _read_csv

SMILES = [
    ("ethanol", "CCO"), ("p-cresol", "Cc1ccc(O)cc1"), ("aspirin", "CC(=O)Oc1ccccc1C(=O)O"),
    ("caffeine", "Cn1cnc2c1c(=O)n(C)c(=O)n2C"), ("benzamidine", "NC(=N)c1ccccc1"),
    ("acetate", "CC(=O)[O-]"), ("chlorobenzene", "Clc1ccccc1"), ("piperazine", "C1CNCCN1"),
    ("acetonitrile", "C#N"),
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The embedder's CPU path is thousands of small torch ops; with one
    OpenMP thread per op they run as fast alone and do not crawl when the
    suite's workers share the cores (8 threads a worker took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("smiles")
    bench.make_synthetic_model(num_clusters=12, seed=3).save(str(root / "model.pm"))
    lines = [f"{smi} {name}" for name, smi in SMILES]
    lines.insert(3, "C1CC garbage_unclosed_ring")  # skipped, not fatal
    lines.insert(5, "# a comment line")
    lines += [f"{smi} {name}" for name, smi in enumerate_fragment_smiles(12, seed=4)]
    (root / "lib.smi").write_text("\n".join(lines) + "\n")
    return root


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        return len(x["names"]) if "names" in x.files else None


@pytest.mark.parametrize("cpus", [1, 2])
def test_prepack_smiles_numpy_npz_equals_jax(inputs, tmp_path, cpus):
    common = ["--smiles", str(inputs / "lib.smi"), "--seed", "31", "--num_conformers", "4",
              "--cpus", str(cpus)]
    assert j_prepack_main(j_prepack_parser().parse_args(
        [*common, "--embed_backend", "numpy", "-o", str(tmp_path / "jax.npz")])) == 0
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        [*common, "--embed_backend", "numpy", "-o", str(tmp_path / "port.npz"),
         "--device", "cpu"])) == 0
    _npz_equal(tmp_path / "port.npz", tmp_path / "jax.npz")


def test_screening_smiles_matches_jax(inputs, tmp_path):
    common = ["-p", str(inputs / "model.pm"), "--smiles", str(inputs / "lib.smi"),
              "--batch_size", "8", "--num_conformers", "6"]
    assert j_screen_main(j_screen_parser().parse_args([*common, "-o", str(tmp_path / "j.csv")])) == 0
    assert t_screen.main(t_screen.build_parser().parse_args(
        [*common, "-o", str(tmp_path / "t.csv"), "--device", "cpu"])) == 0
    _assert_csv_close(tmp_path / "t.csv", tmp_path / "j.csv")
    names = {n for n, _ in _read_csv(tmp_path / "t.csv")}
    assert {n for n, _ in SMILES} <= names and "garbage_unclosed_ring" not in names


def test_prepack_smiles_tiles_compose(inputs, tmp_path):
    """One command from .smi to a tile store, screened by --library_tiles:
    the CSV equals the JAX CLI's --smiles screen."""
    tiles = tmp_path / "tiles"
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        ["--smiles", str(inputs / "lib.smi"), "-p", str(inputs / "model.pm"),
         "--tiles_out", str(tiles), "--batch_size", "8", "--embed_backend", "numpy",
         "--device", "cpu"])) == 0
    assert t_screen.main(t_screen.build_parser().parse_args(
        ["-p", str(inputs / "model.pm"), "--library_tiles", str(tiles),
         "-o", str(tmp_path / "t.csv"), "--device", "cpu"])) == 0
    assert j_screen_main(j_screen_parser().parse_args(
        ["-p", str(inputs / "model.pm"), "--smiles", str(inputs / "lib.smi"),
         "-o", str(tmp_path / "j.csv")])) == 0
    _assert_csv_close(tmp_path / "t.csv", tmp_path / "j.csv")


@pytest.mark.parametrize("smiles", ["Cc1ccc(O)cc1", "CC(N)C(=O)Oc1ccccc1", "[H]OC([H])([H])C"])
def test_scoring_smiles_dg_equals_jax(inputs, smiles):
    t_model = TModel.load(str(inputs / "model.pm"))
    j_model = JModel.load(str(inputs / "model.pm"))
    got = t_model.scoring_smiles(smiles, 4, conformer_engine="dg")
    want = j_model.scoring_smiles(smiles, 4, conformer_engine="dg")
    assert got == pytest.approx(want, rel=2e-5, abs=1e-4)
    if importlib.util.find_spec("rdkit") is None:
        with pytest.raises(ImportError):
            t_model.scoring_smiles(smiles, 2, conformer_engine="rdkit")
        assert t_model.scoring_smiles(smiles, 4) == got  # auto -> dg without RDKit


def test_torch_embedded_library_screens_equal(inputs, tmp_path, monkeypatch):
    """The torch backend (CPU here) embeds the library; both packages'
    --library screens of it agree."""
    from pharmaconet_tpu_torch.chem import embed

    monkeypatch.setattr(embed, "_CHUNK_ROWS", 32)
    packed, names = build_library_from_smiles(inputs / "lib.smi", num_conformers=4,
                                              embed_backend="torch", device="cpu")
    assert len(names) >= len(SMILES) + 10 and "garbage_unclosed_ring" not in names
    save_library(tmp_path / "lib.npz", packed, names)
    common = ["-p", str(inputs / "model.pm"), "--library", str(tmp_path / "lib.npz"),
              "--batch_size", "8"]
    assert j_screen_main(j_screen_parser().parse_args([*common, "-o", str(tmp_path / "j.csv")])) == 0
    assert t_screen.main(t_screen.build_parser().parse_args(
        [*common, "-o", str(tmp_path / "t.csv"), "--device", "cpu"])) == 0
    _assert_csv_close(tmp_path / "t.csv", tmp_path / "j.csv")
    # auto on the CPU device embeds with numpy: the JAX package's numpy library
    auto, auto_names = build_library_from_smiles(inputs / "lib.smi", num_conformers=4,
                                                 device="cpu")
    numpy_lib, numpy_names = build_library_from_smiles(inputs / "lib.smi", num_conformers=4,
                                             embed_backend="numpy", device="cpu")
    assert auto_names == numpy_names
    for a, b in zip(auto, numpy_lib):
        np.testing.assert_array_equal(a.node_pos, b.node_pos)


def test_clis_raise_on_cuda_without_card(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    smi = str(inputs / "lib.smi")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_screen.main(t_screen.build_parser().parse_args(
            ["-p", str(inputs / "model.pm"), "--smiles", smi, "-o", str(tmp_path / "o.csv")]))
    for backend in ("auto", "torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_prepack.main(t_prepack.build_parser().parse_args(
                ["--smiles", smi, "-o", str(tmp_path / "o.npz"), "--embed_backend", backend,
                 "--device", "cuda"]))
    assert not (tmp_path / "o.csv").exists() and not (tmp_path / "o.npz").exists()
