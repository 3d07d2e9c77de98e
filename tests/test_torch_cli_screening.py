"""The port's screening CLI (--device cpu) against the JAX package's CLI.

The live routes: -d over a directory of .sdf/.mol2 files, and --library
over a prepacked .npz written by the JAX `prepack` CLI (the stored route,
--library_tiles, is in test_torch_tiled_store.py). The CSVs
must list the same ligands with scores within rtol 2e-5 / atol 1e-4, and a
screen resumed from <out>.partial must give the same CSV. The mesh branch
(the CLI's `_screening_mesh` patched to three CPU devices: a
`ShardedScreener`) must write the single-device CLI's CSV on -d, --library
and --library_tiles, and resume from <out>.partial.
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


# --------------------------------------------------------------------------
# The mesh branch: more than one device (here three CPU devices)
# --------------------------------------------------------------------------
@pytest.fixture
def mesh3(monkeypatch):
    """The CLI shards over three CPU devices; returns the sharded calls
    made: ("packed", ligands) per score_packed, ("group", batches) per
    score_stored_group and ("single", 1) per stored batch dispatched alone
    on the home device."""
    from pharmaconet_tpu_torch.parallel.screening import ShardedScreener

    monkeypatch.setattr(t_cli, "_screening_mesh", lambda args: [torch.device("cpu")] * 3)
    calls = []
    for name, tag in (("score_packed", "packed"), ("score_stored_group", "group"),
                      ("dispatch_stored", "single")):
        real = getattr(ShardedScreener, name)

        def spy(self, batch, _real=real, _tag=tag):
            calls.append((_tag, 1 if _tag == "single" else len(batch)))
            return _real(self, batch)

        monkeypatch.setattr(ShardedScreener, name, spy)
    return calls


@pytest.mark.parametrize("route", ["dir", "library"])
def test_mesh_branch_equals_single_device(inputs, tmp_path, mesh3, route):
    """-d and --library on a mesh: each batch of --batch_size goes to
    ShardedScreener.score_packed (shares over the devices), the CSV equals
    the single-device CLI's, and --library resumes from <out>.partial."""
    src = ["--library", str(inputs / "lib.npz")] if route == "library" else \
        ["-d", str(inputs / "ligands")]
    common = ["-p", str(inputs / "model.pm"), *src, "--batch_size", "16"]
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "mesh.csv"))) == 0
    assert mesh3 == [("packed", 16), ("packed", 16), ("packed", 8)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cli, "_screening_mesh", lambda args: None)
        assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "single.csv"))) == 0
    _assert_csv_close(tmp_path / "mesh.csv", tmp_path / "single.csv")
    if route == "dir":
        return
    full = dict(_read_csv(tmp_path / "mesh.csv"))
    from pharmaconet_tpu_torch.scoring.library import load_library

    _, names = load_library(inputs / "lib.npz")
    partial = tmp_path / "resumed.csv.partial"
    partial.write_text("".join(f"{i},{names[i]},{full[names[i]]}\n" for i in range(5))
                       + f"5,{names[5][:6]}")
    mesh3.clear()
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "resumed.csv"))) == 0
    assert mesh3 == [("packed", 16), ("packed", 16), ("packed", 3)]
    assert (tmp_path / "resumed.csv").read_text() == (tmp_path / "mesh.csv").read_text()
    assert not partial.exists()


def test_mesh_branch_library_tiles(inputs, tmp_path, mesh3):
    """--library_tiles on a mesh of three: groups of three non-empty
    batches through score_stored_group, the leftovers one at a time on the
    home device, an empty batch as zeros; the CSV equals the single-device
    CLI's, and a screen resumed from <out>.partial (the first batch and a
    bit done, a torn line) gives the uninterrupted one's scores."""
    from pharmaconet_tpu_torch.cli import prepack as t_prepack
    from pharmaconet_tpu_torch.scoring import batch_screen as tbs
    from pharmaconet_tpu_torch.scoring.library import load_library, save_library
    from test_torch_tiled_store import _empty

    packed, names = load_library(inputs / "lib.npz")
    save_library(tmp_path / "lib.npz", packed + [_empty(tbs)] * 8,
                 names + [f"empty{i}" for i in range(8)])
    tiles = tmp_path / "tiles"
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        ["--library", str(tmp_path / "lib.npz"), "-p", str(inputs / "model.pm"), "--tiles_out",
         str(tiles), "--batch_size", "8", "--device", "cpu"])) == 0
    common = ["-p", str(inputs / "model.pm"), "--library_tiles", str(tiles)]
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "mesh.csv"))) == 0
    assert mesh3 == [("group", 3), ("single", 1), ("single", 1)]  # 5 batches, then 1 empty
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cli, "_screening_mesh", lambda args: None)
        assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "single.csv"))) == 0
    _assert_csv_close(tmp_path / "mesh.csv", tmp_path / "single.csv")
    full = dict(_read_csv(tmp_path / "mesh.csv"))
    assert [full[f"empty{i}"] for i in range(8)] == [0.0] * 8

    all_names = names + [f"empty{i}" for i in range(8)]
    partial = tmp_path / "resumed.csv.partial"
    partial.write_text("".join(f"{i},{all_names[i]},{full[all_names[i]]}\n" for i in range(10))
                       + f"10,{all_names[10][:4]}")
    mesh3.clear()
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "resumed.csv"))) == 0
    assert mesh3 == [("group", 3), ("single", 1)]  # batches 1-3, then 4; 5 is empty
    # the same rows; ligands of equal score may be listed in another order,
    # since a group's batches are written before an earlier empty batch's
    resumed = _read_csv(tmp_path / "resumed.csv")
    assert dict(resumed) == full and len(resumed) == len(full)
    assert [s for _, s in resumed] == sorted(full.values(), reverse=True)
    assert not partial.exists()


def test_profile_writes_the_trace_and_the_spans(inputs, tmp_path):
    """--profile DIR on --library_tiles: the CSV equals a screen without
    it, and DIR holds one Chrome trace with the program's pmnet.* spans
    and, beside it, the spans and counters as JSON: one pmnet.dispatch
    per batch, its copy-out and pageable copy under it."""
    import json

    from pharmaconet_tpu_torch.cli import prepack as t_prepack

    tiles = tmp_path / "tiles"
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        ["--library", str(inputs / "lib.npz"), "-p", str(inputs / "model.pm"), "--tiles_out",
         str(tiles), "--batch_size", "8", "--device", "cpu"])) == 0
    common = ["-p", str(inputs / "model.pm"), "--library_tiles", str(tiles)]
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "plain.csv"))) == 0
    assert t_cli.main(_port_args(*common, "-o", str(tmp_path / "prof.csv"), "--profile",
                                 str(tmp_path / "trace"))) == 0
    assert (tmp_path / "prof.csv").read_text() == (tmp_path / "plain.csv").read_text()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "pmnet.dispatch" for e in events) == 5  # 40 ligands, batches of 8
    written = json.loads(traces[0].with_name(
        traces[0].name.replace(".pt.trace.json", ".pmnet.json")).read_text())
    spans = written["spans"]
    dispatch = {s["id"]: s["bi"] for s in spans if s["name"] == "pmnet.dispatch"}
    assert sorted(dispatch.values()) == list(range(5))
    copies = [s for s in spans if s["name"] in ("pmnet.dispatch.copy_out", "pmnet.dispatch.h2d")]
    assert copies and all(dispatch[s["parent"]] == s["bi"] for s in copies)
    assert written["counts"]["pmnet.h2d_bytes"] >= written["counts"]["pmnet.copy_out_bytes"] > 0
