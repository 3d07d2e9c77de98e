"""Ligand detection (`utils.rcsb`), the modeling CLI's detection paths and
`network.necks` in the port against the JAX package.

The PDB is the synthetic pocket of `test_torch_modeling.py` with two HET
ligands (LIG on chain A, MOV on chain B; 6 atoms each, in the cavity) and
a water (HOH, skipped), plus HETNAM/HETSYN records. Both CLIs build the
small network of `test_torch_modeling.py` from one .npz checkpoint. No
test touches the network: `--pdb` runs with `urllib.request.urlopen`
stubbed.

Tolerances: ligand records, ligand files and `.pm` graphs equal (node
types, indices, edges and clusters); node centres, radii and edge
distances within 1e-5 and node scores within 1e-6 of the JAX CLI's, as in
`test_torch_modeling.py` (both compute in f32 on the CPU, in another
summation order). Two runs of the port on the same site give identical
`.pm` states.
"""

from __future__ import annotations

import builtins
import logging
import pickle
import shutil
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import save_npz_checkpoint
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu.utils import rcsb as jrcsb
from pharmaconet_tpu_torch.network.convert import random_distributions
from pharmaconet_tpu_torch.synthetic import append_het_ligands, write_synthetic_pocket
from pharmaconet_tpu_torch.utils import rcsb

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 32
KW = dict(verbose=False, max_hotspots=8, segmentation_chunk=4, grid_dim=GRID,
          model_kwargs=SMALL, score_threshold=0.5)
NAMES = {"LIG": "TEST LIGAND", "MOV": "OTHER LIGAND"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores, and 8 threads a worker made these tests 15x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rcsb")
    info = write_synthetic_pocket(tmp / "plain.pdb", seed=0, cavity_radius=3.0,
                                  num_atoms=1500, outer_radius=24.0)
    c = info["center"]
    shutil.copy(tmp / "plain.pdb", tmp / "complex.pdb")
    append_het_ligands(tmp / "complex.pdb", [
        ("LIG", "A", 901, c), ("HOH", "A", 902, (c[0] + 2.6, c[1], c[2] - 1.0)),
        ("MOV", "B", 1, (c[0], c[1] + 1.4, c[2] + 1.2))], NAMES)
    text = (tmp / "complex.pdb").read_text()
    (tmp / "complex.pdb").write_text(text.replace(
        "HETNAM     LIG TEST LIGAND\n",
        "HETNAM     LIG TEST LIGAND-\nHETNAM   2 LIG WITH A LONG NAME\nHETSYN     LIG SYN ONE\n"))
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    params = jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 3))
    params["params"]["mask_head"]["conv_logits"]["bias"][:] = 1.0
    save_npz_checkpoint(tmp / "small.npz", params, random_distributions())
    return SimpleNamespace(tmp=tmp, center=c, plain=tmp / "plain.pdb",
                           complex=tmp / "complex.pdb")


# --------------------------------------------------------------------------
# rcsb
# --------------------------------------------------------------------------
def test_parse_pdb_matches_jax(case, tmp_path):
    got = rcsb.parse_pdb("cx", case.complex, tmp_path / "port")
    want = jrcsb.parse_pdb("cx", case.complex, tmp_path / "jax")
    assert [i.id for i in got] == ["LIG", "MOV"]  # HOH skipped
    assert got[0].name == "TEST LIGAND-WITH A LONG NAME" and got[0].synonyms == "SYN ONE"
    assert (got[1].pdbchain, got[1].authchain, got[1].order) == ("D", "B", 3)
    np.testing.assert_allclose(got[0].center, case.center, atol=1e-9)
    for a, b in zip(got, want, strict=True):
        da, db = vars(a).copy(), vars(b).copy()
        pa, pb = Path(da.pop("file_path")), Path(db.pop("file_path"))
        assert da == db and pa.name == pb.name
        assert pa.read_text() == pb.read_text()
        assert str(a) == str(b)
    assert rcsb.parse_pdb("plain", case.plain, tmp_path / "none") == []


def test_het_names_match_jax(case):
    lines = case.complex.read_text().splitlines()
    for record in ("HETNAM", "HETSYN"):
        assert rcsb._parse_het_names(lines, record) == jrcsb._parse_het_names(lines, record)


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "fails"])
def test_download_pdb_stubbed(case, tmp_path, monkeypatch, fails, capsys):
    calls = []

    class Response:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return case.complex.read_bytes()

    def fake_urlopen(url, timeout=None):
        calls.append(url)
        if fails:
            raise OSError("unreachable")
        return Response()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    for mod, name in ((rcsb, "port.pdb"), (jrcsb, "jax.pdb")):
        assert mod.download_pdb("1ABC", tmp_path / name) is (not fails)
    assert calls == ["https://files.rcsb.org/download/1abc.pdb"] * 2
    if not fails:
        assert (tmp_path / "port.pdb").read_text() == case.complex.read_text()
    else:
        assert not (tmp_path / "port.pdb").exists()


def test_center_crop_matches_jax():
    from pharmaconet_tpu.network import necks as jnecks
    from pharmaconet_tpu_torch.network import necks

    x = np.random.default_rng(0).normal(size=(2, 9, 8, 7, 3)).astype(np.float32)
    for size in (4, (5, 3, 7), (9, 8, 7)):
        np.testing.assert_array_equal(necks.center_crop(torch.from_numpy(x), size).numpy(),
                                      np.asarray(jnecks.center_crop(x, size)))
    levels = [x, x[:, :6, :6, :6]]
    got = necks.CenterCropNeck([4, 2])([torch.from_numpy(a) for a in levels])
    want = jnecks.CenterCropNeck([4, 2])(levels)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(AssertionError):
        necks.center_crop(torch.from_numpy(x), 10)


# --------------------------------------------------------------------------
# The modeling CLI's ligand detection
# --------------------------------------------------------------------------
def _shrink_networks(monkeypatch) -> list:
    """Both CLIs build the small network with the cavity gate open; returns
    the list of the port's network builds."""
    import pharmaconet_tpu.module as jax_module
    import pharmaconet_tpu_torch.module as module

    made = []

    def shrink(cls, record):
        class Small(cls):
            def __init__(self, **kwargs):
                record.append(kwargs)
                super().__init__(**{**kwargs, **{k: v for k, v in KW.items()
                                                  if k != "verbose"}})
                self.focus_threshold = 0.0
        return Small

    monkeypatch.setattr(module, "PharmacoNet", shrink(module.PharmacoNet, made))
    monkeypatch.setattr(jax_module, "PharmacoNet", shrink(jax_module.PharmacoNet, []))
    monkeypatch.setenv("PMNET_TPU_NO_COMPILE_CACHE", "1")
    return made


@pytest.fixture
def small(monkeypatch):
    return _shrink_networks(monkeypatch)


def _port_cli(case, out_dir, *extra) -> int:
    from pharmaconet_tpu_torch.cli.modeling import build_parser, main

    return main(build_parser().parse_args([
        "--prefix", "cx", "--out_dir", str(out_dir), "--weight_path",
        str(case.tmp / "small.npz"), "--device", "cpu", *extra]))


def _jax_cli(case, out_dir, *extra) -> int:
    from pharmaconet_tpu.cli.modeling import build_parser, main

    return main(build_parser().parse_args([
        "--prefix", "cx", "--out_dir", str(out_dir), "--weight_path",
        str(case.tmp / "small.npz"), *extra]))


def _state(path: Path) -> dict:
    return pickle.loads(path.read_bytes())


def _assert_pm_close(got: dict, want: dict):
    assert got["pdbblock"] == want["pdbblock"]
    assert len(got["nodes"]) == len(want["nodes"]) > 0
    for a, b in zip(got["nodes"], want["nodes"]):
        for key in ("index", "type", "interaction_type", "hotspot_position",
                    "neighbor_edge_dict", "overlapped_nodes"):
            assert a[key] == b[key], key
        assert abs(a["score"] - b["score"]) <= 1e-6
        np.testing.assert_allclose(a["center"], b["center"], atol=1e-5)
        assert abs(a["radius"] - b["radius"]) <= 1e-5
    assert [(e["node_indices"], e["edge_type"]) for e in got["edges"]] == \
        [(e["node_indices"], e["edge_type"]) for e in want["edges"]]
    for a, b in zip(got["edges"], want["edges"]):
        np.testing.assert_allclose([a["distance_mean"], a["distance_std"]],
                                   [b["distance_mean"], b["distance_std"]], atol=1e-5)
    assert {k: [c["node_indices"] for c in v] for k, v in got["node_cluster_dict"].items()} == \
        {k: [c["node_indices"] for c in v] for k, v in want["node_cluster_dict"].items()}


SITES = ("cx_B_LIG_model.pm", "cx_D_MOV_model.pm")


@pytest.fixture(scope="module")
def both_all(case, tmp_path_factory):
    """`--all` on the two-ligand PDB through both CLIs."""
    mp = pytest.MonkeyPatch()
    try:
        made = _shrink_networks(mp)
        out = tmp_path_factory.mktemp("all")
        assert _port_cli(case, out / "port", "-p", str(case.complex), "--all") == 0
        assert len(made) == 1  # one network for both sites
        assert _jax_cli(case, out / "jax", "-p", str(case.complex), "--all") == 0
    finally:
        mp.undo()
    return out


def test_all_sites_match_jax(case, both_all):
    port, jax_dir = both_all / "port", both_all / "jax"
    assert sorted(p.name for p in port.glob("*.pm")) == list(SITES)
    for site in SITES:
        _assert_pm_close(_state(port / site), _state(jax_dir / site))
        ligand = site.replace("_model.pm", ".pdb")
        assert (port / ligand).read_text() == (jax_dir / ligand).read_text()
    assert (port / "cx.pml").exists() or (port / "cx.pse").exists()
    assert (port / "cx_B_LIG_model_pymol.pml").exists() or \
        (port / "cx_B_LIG_model_pymol.pse").exists()


@pytest.mark.parametrize("extra,site", [(["--ligand_id", "lig"], SITES[0]),
                                        (["--chain", "a"], SITES[0]),
                                        (["--chain", "D"], SITES[1]),
                                        (["--ligand_id", "MOV", "--chain", "B"], SITES[1])],
                         ids=["ligand_id", "auth-chain", "pdb-chain", "id-and-chain"])
def test_ligand_selection(case, both_all, small, tmp_path, extra, site):
    """--ligand_id and --chain (either the ligand's own chain letter or its
    author chain) narrow the detected sites to one."""
    assert _port_cli(case, tmp_path, "-p", str(case.complex), *extra) == 0
    assert [p.name for p in tmp_path.glob("*.pm")] == [site]
    assert _state(tmp_path / site) == _state(both_all / "port" / site)


def test_no_matching_ligand_fails(case, small, tmp_path):
    assert _port_cli(case, tmp_path, "-p", str(case.complex), "--ligand_id", "XYZ") == 2
    assert small == []


def test_ref_ligand_equals_detected_site(case, both_all, small, tmp_path):
    """--ref_ligand on the ligand file parse_pdb wrote gives the .pm of the
    detected site (the same centre)."""
    ligand = both_all / "port" / "cx_B_LIG.pdb"
    assert _port_cli(case, tmp_path, "-p", str(case.complex), "--ref_ligand", str(ligand)) == 0
    assert _state(tmp_path / "cx_cx_B_LIG_model.pm") == _state(both_all / "port" / SITES[0])


def test_interactive_pick(case, both_all, small, tmp_path, monkeypatch, caplog):
    """Several ligands and no selection flag: the CLI asks; an invalid
    answer is asked again, '1,3' models both (here from the cache of the
    --all run: no network is built), 'exit' returns 1."""
    shutil.copytree(both_all / "port", tmp_path / "out")
    answers = iter(["7", "1,3", "exit"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    with caplog.at_level(logging.INFO):
        assert _port_cli(case, tmp_path / "out", "-p", str(case.complex)) == 0
    assert "Invalid selection: 7" in caplog.text and caplog.text.count("exists") == 2
    assert "A total of 2 ligand(s) detected" in caplog.text
    assert _port_cli(case, tmp_path / "out", "-p", str(case.complex)) == 1
    assert small == []


def test_no_ligand_prompts_for_a_center(case, small, tmp_path, monkeypatch):
    x, y, z = case.center
    answers = iter([str(x), str(y), str(z)])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(answers))
    assert _port_cli(case, tmp_path / "port", "-p", str(case.plain)) == 0
    assert _jax_cli(case, tmp_path / "jax", "-p", str(case.plain), "--center", str(x), str(y),
                    str(z)) == 0
    name = f"cx_{x}_{y}_{z}_model.pm"
    _assert_pm_close(_state(tmp_path / "port" / name), _state(tmp_path / "jax" / name))


def test_pdb_code_downloads_once(case, both_all, small, tmp_path, monkeypatch):
    calls = []

    class Response:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return case.complex.read_bytes()

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=None: calls.append(url) or Response())
    from pharmaconet_tpu_torch.cli.modeling import build_parser, main

    argv = ["--pdb", "1abc", "--ligand_id", "LIG", "--out_dir", str(tmp_path), "--weight_path",
            str(case.tmp / "small.npz"), "--device", "cpu"]
    assert main(build_parser().parse_args(argv)) == 0
    assert (tmp_path / "1abc.pdb").read_text() == case.complex.read_text()
    got = _state(tmp_path / "1abc_B_LIG_model.pm")
    want = _state(both_all / "port" / SITES[0])
    assert {k: v for k, v in got.items() if k != "pdbblock"} == \
        {k: v for k, v in want.items() if k != "pdbblock"}
    assert main(build_parser().parse_args(argv)) == 0  # the file and the model are cached
    assert len(calls) == 1 and len(small) == 1
