"""Tile stores (scoring/tiled_store.py) across the two packages, on the CPU.

Stores written by `pharmaconet_tpu` and by the port from the same library
and model must hold the same files and arrays; a store written by either
package must screen in the other with scores equal to that package's own
score_stored, to the port's live path and to the reference engine, within
rtol 2e-5 / atol 1e-4. Every dispatch branch of the stored route is
covered: v3 with leaf buckets (sparse and dense wire), with single-window
leaves, with leaf outliers, without leaves (K2 + compaction on the
device), v2 (K3) and v1 (K1). Plus the reader (iter_loaded, fingerprint,
empty batches, the int32 pad sentinel) and the CLI round trip.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import bench
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring import library as jlib
from pharmaconet_tpu.scoring import tiled_store as jts
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.cli import prepack as t_prepack
from pharmaconet_tpu_torch.cli import screening as t_cli
from pharmaconet_tpu_torch.ops import screen_ref
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import library as tlib
from pharmaconet_tpu_torch.scoring import tiled_store as tts

RTOL, ATOL = 2e-5, 1e-4
BATCH = 16
KINDS = {  # store kind -> (writer, keyword arguments)
    "v3": ("v3", {}),
    "v3_dense": ("v3", dict(leaf_wire="dense")),
    "v3_single": ("v3", dict(leaf_layout="single")),
    "v3_outliers": ("v3", dict(leaf_caps=(24, 64))),
    "v3_noleaf": ("v3", dict(bake_leaves=False)),
    "v2": ("v2", {}),
}


def _empty(pkg, c=1):
    return pkg.PackedLigand(
        node_pos=np.zeros((0, c, 3), np.float32), node_mask=np.zeros(0, np.int32),
        clusters=[], cluster_mask=np.zeros(0, np.int32),
        cluster_center=np.zeros((0, c, 3), np.float32),
        cluster_size=np.zeros((0, c), np.float32), num_conformers=c,
    )


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """96 ligands in 6 batches of 16: 56 random molecules from files, 24
    synthetic ligands of 3 conformers, and 16 cluster-less ligands that
    fill the last batch (an empty batch). The same library in each
    package's PackedLigand, and the 12-cluster model saved as a .pm."""
    root = tmp_path_factory.mktemp("tiles")
    model = synthetic.make_synthetic_model(num_clusters=12, seed=5)
    model.save(str(root / "model.pm"))
    files = synthetic.write_random_library(root / "ligands", 56, seed=33)
    tlib.save_library(root / "files.npz", *tlib.build_library_from_files(files))
    t_lig, names = tlib.load_library(root / "files.npz")
    j_lig, _ = jlib.load_library(root / "files.npz")
    t_lig += synthetic.make_synthetic_ligands(24, num_conformers=3, seed=4)
    j_lig += bench.make_synthetic_ligands(24, num_conformers=3, seed=4)
    t_lig += [_empty(tbs) for _ in range(BATCH)]
    j_lig += [_empty(jbs) for _ in range(BATCH)]
    names += [f"s{i:02d}" for i in range(40)]
    tlib.save_library(root / "lib.npz", t_lig, names)
    t_pm = tbs.PackedModel.from_model(model)
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=12, seed=5))
    ref = tbs.BatchScreener(t_pm, engine="reference", device="cpu").score_packed(t_lig)
    assert sum(r > 0 for r in ref) >= 40, "corpus too easy"
    return dict(root=root, t_pm=t_pm, j_pm=j_pm, t_lig=t_lig, j_lig=j_lig,
                names=names, ref=ref)


@pytest.fixture(scope="module")
def stores(corpus):
    """Every store kind written by both packages: {(package, kind): path}."""
    out = {}
    for pkg, mod, pm, lig in (("jax", jts, corpus["j_pm"], corpus["j_lig"]),
                              ("port", tts, corpus["t_pm"], corpus["t_lig"])):
        for kind, (writer, kw) in KINDS.items():
            path = corpus["root"] / f"{pkg}_{kind}"
            if writer == "v2":
                mod.write_tiled_store(path, pm, lig, corpus["names"], batch_size=BATCH,
                                      verbose=False)
            else:
                if pkg == "port" and kw.get("bake_leaves", True):
                    kw = dict(kw, device="cpu")
                mod.write_v3_store(path, pm, lig, corpus["names"], batch_size=BATCH,
                                   verbose=False, **kw)
            out[pkg, kind] = path
    return out


def _screen(screener, path, pm) -> list[float]:
    store = (tts if isinstance(screener, tbs.BatchScreener) else jts).TiledStore(path, pm)
    scores: list[float] = []
    for bi in range(store.n_batches):
        scores.extend(screener.score_stored(store.load(bi)))
    return scores


def _files(path: Path) -> dict[str, Path]:
    return {p.relative_to(path).as_posix(): p for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_stores_equal_across_packages(stores, kind):
    """Same files, same meta, same arrays, leaf bake included: no ligand
    of this corpus is demoted as sign-risky by one package and not the
    other."""
    jf, tf = _files(stores["jax", kind]), _files(stores["port", kind])
    assert sorted(jf) == sorted(tf)
    for rel, jp in jf.items():
        tp = tf[rel]
        if rel.endswith(".json"):
            assert json.loads(tp.read_text()) == json.loads(jp.read_text())
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tp), np.load(jp), err_msg=rel)
        else:
            ja, ta = np.load(jp), np.load(tp)
            assert sorted(ja.files) == sorted(ta.files), rel
            for k in ja.files:
                np.testing.assert_array_equal(ta[k], ja[k], err_msg=f"{rel}:{k}")


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_screens_equal_in_both_packages(corpus, stores, kind, writer):
    """A store written by either package scores the same in the port
    (plain K1/K2/K3 + torch leaf chain on the CPU) as in the JAX package
    (interpret-mode Pallas), as the port's live path and as the reference
    engine."""
    path = stores[writer, kind]
    got = _screen(tbs.BatchScreener(corpus["t_pm"], device="cpu"), path, corpus["t_pm"])
    want = _screen(jbs.BatchScreener(corpus["j_pm"], pallas_interpret=True), path,
                   corpus["j_pm"])
    live = tbs.BatchScreener(corpus["t_pm"], device="cpu").score_packed(corpus["t_lig"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, live, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, corpus["ref"], rtol=RTOL, atol=ATOL)
    assert got[-BATCH:] == [0.0] * BATCH


def test_store_branches(stores, corpus):
    """Each store kind reaches the dispatch branch it is meant to cover."""
    store = {k: tts.TiledStore(stores["port", k], corpus["t_pm"]) for k in KINDS}
    assert store["v3"].load(0).leaf_buckets is not None
    assert len(store["v3"].load(0).leaf_buckets[0]) == 7  # sparse wire
    assert len(store["v3_dense"].load(0).leaf_buckets[0]) == 6
    assert store["v3_single"].load(0).leaf2_ps is not None
    assert any(len(store["v3_outliers"].load(bi).leaf2_out["live"])
               for bi in range(5))
    sb = store["v3_noleaf"].load(0)
    assert sb.leaf_buckets is None and sb.leaf2_ps is None and sb.ends_padded is not None
    sb = store["v2"].load(0)
    assert sb.dt is not None and sb.dt.shape == (sb.gtab.shape[0], 3, 1024)
    for k in KINDS:
        last = store[k].load(store[k].n_batches - 1)
        assert last.empty and last.batch_len == BATCH


def test_iter_loaded_equals_load(stores, corpus):
    store = tts.TiledStore(stores["port", "v3"], corpus["t_pm"])
    seen = []
    for bi, sb in store.iter_loaded(range(store.n_batches), prefetch=2):
        seen.append(bi)
        ref = store.load(bi)
        for name, a in vars(sb).items():
            b = getattr(ref, name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            elif isinstance(a, tuple):
                for x, y in zip(a, b):
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v)
            elif isinstance(a, dict):
                assert a.keys() == b.keys()
            else:
                assert a == b, name
    assert seen == list(range(store.n_batches))


def test_fingerprint_mismatch_raises(stores):
    other = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=12, seed=6))
    with pytest.raises(ValueError, match="different pharmacophore"):
        tts.TiledStore(stores["port", "v3"], other)


def test_v1_store_runs_k1(stores, corpus, tmp_path, monkeypatch):
    """A store without dt.npy (version 1) screens through K1 (its plain
    version on the CPU) with the same scores."""
    path = tmp_path / "v1"
    shutil.copytree(stores["port", "v2"], path)
    for f in path.rglob("dt.npy"):
        f.unlink()
    meta = json.loads((path / "meta.json").read_text())
    (path / "meta.json").write_text(json.dumps(dict(meta, version=1)))
    calls = []
    real = screen_ref.score_tiles_fused_rows
    monkeypatch.setattr(screen_ref, "score_tiles_fused_rows",
                        lambda *a: calls.append(1) or real(*a))
    got = _screen(tbs.BatchScreener(corpus["t_pm"], device="cpu"), path, corpus["t_pm"])
    np.testing.assert_allclose(got, corpus["ref"], rtol=RTOL, atol=ATOL)
    assert len(calls) == 5  # one per non-empty batch


def test_loader_checks_the_sparse_pad_sentinel(stores, corpus, tmp_path):
    path = tmp_path / "big"
    shutil.copytree(stores["port", "v3"], path)
    meta = json.loads((path / "meta.json").read_text())
    meta["leaf2_buckets"][0] = [2**16, 2**8, 2**8]
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tts.TiledStore(path, corpus["t_pm"]).load(0)


def _csv(path: Path) -> dict[str, float]:
    lines = path.read_text().splitlines()
    assert lines[0] == "path,score"
    scores = [float(line.rsplit(",", 1)[1]) for line in lines[1:]]
    assert scores == sorted(scores, reverse=True)
    return {n: float(s) for n, s in (line.rsplit(",", 1) for line in lines[1:])}


@pytest.mark.parametrize("version", ["3", "2"])
def test_cli_prepack_and_library_tiles(corpus, tmp_path, version):
    """prepack -d -> .npz, prepack --library --tiles_out (v3 default or
    --tiles_version 2), screening --library_tiles: the CSV equals the
    --library CSV; an interrupted screen resumes from <out>.partial."""
    root = corpus["root"]
    model = str(root / "model.pm")
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        ["-d", str(root / "ligands"), "-o", str(tmp_path / "lib.npz")])) == 0
    tiles = str(tmp_path / "tiles")
    assert t_prepack.main(t_prepack.build_parser().parse_args(
        ["--library", str(tmp_path / "lib.npz"), "-p", model, "--tiles_out", tiles,
         "--batch_size", "8", "--tiles_version", version, "--device", "cpu"])) == 0
    assert json.loads(Path(tiles, "meta.json").read_text())["version"] == int(version)

    def screen(*src, out):
        return t_cli.main(t_cli.build_parser().parse_args(
            ["-p", model, *src, "-o", str(out), "--batch_size", "8", "--device", "cpu"]))

    assert screen("--library", str(tmp_path / "lib.npz"), out=tmp_path / "lib.csv") == 0
    assert screen("--library_tiles", tiles, out=tmp_path / "tiles.csv") == 0
    want, got = _csv(tmp_path / "lib.csv"), _csv(tmp_path / "tiles.csv")
    assert got.keys() == want.keys() and len(got) == 56
    names = sorted(want)
    np.testing.assert_allclose([got[n] for n in names], [want[n] for n in names],
                               rtol=RTOL, atol=ATOL)
    assert not (tmp_path / "tiles.csv.partial").exists()

    # resume: the first 11 entries (a batch and a bit) and a torn line
    store_names = tts.TiledStore(tiles).names()
    partial = tmp_path / "resumed.csv.partial"
    partial.write_text("".join(f"{i},{store_names[i]},{got[store_names[i]]}\n"
                               for i in range(11)) + f"11,{store_names[11][:4]}")
    assert screen("--library_tiles", tiles, out=tmp_path / "resumed.csv") == 0
    assert (tmp_path / "resumed.csv").read_text() == (tmp_path / "tiles.csv").read_text()
    assert not partial.exists()


def test_cli_prepack_refusals(corpus, tmp_path, capsys):
    parse = t_prepack.build_parser().parse_args
    # --smiles is ported (tests/test_torch_smiles_library.py); with nothing
    # to write it is refused like every other source
    (tmp_path / "x.smi").write_text("CCO ethanol\n")
    assert t_prepack.main(parse(["--smiles", str(tmp_path / "x.smi"), "--device", "cpu"])) == 2
    assert "nothing to do" in capsys.readouterr().err
    assert t_prepack.main(parse(["--library", str(corpus["root"] / "lib.npz"),
                                 "--tiles_out", str(tmp_path / "t")])) == 2
    assert "-p/--pharmacophore_model" in capsys.readouterr().err
    assert not (tmp_path / "t").exists()
