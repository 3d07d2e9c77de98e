"""The port's screening CLI (--device cpu) against the JAX package's CLI.

The live routes: -d over a directory of .sdf/.mol2 files, and --library
over a prepacked .npz written by the JAX `prepack` CLI (the stored route,
--library_tiles, is in test_torch_tiled_store.py). The CSVs
must list the same ligands with scores within rtol 2e-5 / atol 1e-4, and a
screen resumed from <out>.partial must give the same CSV.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.cli.prepack import build_parser as j_prepack_parser
from pharmaconet_tpu.cli.prepack import main as j_prepack_main
from pharmaconet_tpu.cli.screening import build_parser as j_parser
from pharmaconet_tpu.cli.screening import main as j_main
from pharmaconet_tpu_torch.cli import screening as t_cli
from pharmaconet_tpu_torch.synthetic import write_random_library

RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("screen")
    bench.make_synthetic_model(num_clusters=12, seed=3).save(str(root / "model.pm"))
    write_random_library(root / "ligands", 40, seed=11)
    assert j_prepack_main(j_prepack_parser().parse_args(
        ["-d", str(root / "ligands"), "-o", str(root / "lib.npz")]
    )) == 0
    return root


def _read_csv(path) -> list[tuple[str, float]]:
    lines = path.read_text().splitlines()
    assert lines[0] == "path,score"
    rows = [line.rsplit(",", 1) for line in lines[1:]]
    return [(n, float(s)) for n, s in rows]


def _assert_csv_close(got_path, want_path):
    got, want = _read_csv(got_path), _read_csv(want_path)
    scores = [s for _, s in got]
    assert scores == sorted(scores, reverse=True)
    got_d, want_d = dict(got), dict(want)
    assert len(got_d) == len(got) and got_d.keys() == want_d.keys()
    names = sorted(want_d)
    np.testing.assert_allclose([got_d[n] for n in names], [want_d[n] for n in names],
                               rtol=RTOL, atol=ATOL)
    assert max(want_d.values()) > 0.0


def _port_args(*argv):
    return t_cli.build_parser().parse_args([*argv, "--device", "cpu"])


@pytest.mark.parametrize("route", ["dir", "dir_cpus2", "library"])
def test_cli_matches_jax(inputs, tmp_path, route):
    """dir_cpus2 parses in two spawned workers, which must import the
    port's Ligand (parse_pool) and hand back the same molecules."""
    src = (["--library", str(inputs / "lib.npz")] if route == "library"
           else ["-d", str(inputs / "ligands")])
    common = ["-p", str(inputs / "model.pm"), *src, "--batch_size", "16"]
    port_extra = ["--cpus", "2"] if route == "dir_cpus2" else []
    assert j_main(j_parser().parse_args([*common, "-o", str(tmp_path / "jax.csv")])) == 0
    assert t_cli.main(_port_args(*common, *port_extra, "-o", str(tmp_path / "port.csv"))) == 0
    _assert_csv_close(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert not (tmp_path / "port.csv.partial").exists()


def test_library_resume_from_partial(inputs, tmp_path):
    """A crashed --library screen resumes from <out>.partial: the entries
    already there are kept (a torn last line is scored again) and the CSV
    equals an uninterrupted run's."""
    common = ["-p", str(inputs / "model.pm"), "--library", str(inputs / "lib.npz"),
              "--batch_size", "8"]
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "full.csv"))) == 0
    names = [n for n, _ in _read_csv(tmp_path / "full.csv")]
    full = dict(_read_csv(tmp_path / "full.csv"))

    from pharmaconet_tpu_torch.scoring.library import load_library

    _, lib_names = load_library(inputs / "lib.npz")
    assert sorted(lib_names) == sorted(names)
    partial = tmp_path / "resumed.csv.partial"
    keep = [(i, n) for i, n in enumerate(lib_names)][:5]
    partial.write_text(
        "".join(f"{i},{n},{full[n]}\n" for i, n in keep) + f"5,{lib_names[5][:6]}"
    )
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "resumed.csv"))) == 0
    assert (tmp_path / "resumed.csv").read_text() == (tmp_path / "full.csv").read_text()
    assert not partial.exists()


def test_library_from_files_equals_jax_prepack(inputs, tmp_path):
    """The port's build_library_from_files + save_library write the same
    arrays as the JAX prepack CLI from the same directory."""
    from pharmaconet_tpu_torch.scoring.library import build_library_from_files, save_library

    root = inputs / "ligands"
    files = sorted(root.rglob("*.sdf")) + sorted(root.rglob("*.mol2"))
    save_library(tmp_path / "port.npz", *build_library_from_files(files))
    got, want = np.load(tmp_path / "port.npz"), np.load(inputs / "lib.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_unported_routes_exit_nonzero(inputs, tmp_path, capsys):
    """--smiles, the last route that exited 2 as unported, now screens
    (tests/test_torch_smiles_library.py holds it to the JAX CLI); a call
    with no library source still exits non-zero with the usage line."""
    (tmp_path / "lib.smi").write_text("CCO ethanol\nc1ccccc1O phenol\n")
    assert t_cli.main(_port_args("-p", str(inputs / "model.pm"), "--smiles",
                                 str(tmp_path / "lib.smi"), "-o", str(tmp_path / "s.csv"))) == 0
    assert {n for n, _ in _read_csv(tmp_path / "s.csv")} == {"ethanol", "phenol"}
    rc = t_cli.main(_port_args("-p", str(inputs / "model.pm"), "-o", str(tmp_path / "o.csv")))
    assert rc != 0
    assert "provide -d/--library_dir" in capsys.readouterr().err
    assert not (tmp_path / "o.csv").exists()


def test_cuda_without_card_is_an_error(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    args = t_cli.build_parser().parse_args([
        "-p", str(inputs / "model.pm"), "--library", str(inputs / "lib.npz"),
        "-o", str(tmp_path / "o.csv"),
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(args)
    assert not (tmp_path / "o.csv").exists()
