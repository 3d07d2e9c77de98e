"""The port's examples (`examples/*_torch.py`) and its checkpoint download.

`end_to_end_torch.py --device cpu` writes its synthetic pocket (a ligand
at the centre, `synthetic.write_synthetic_site`), models it with the micro
detector and screens 60 generated .sdf ligands; the JAX package's
`end_to_end.py` then runs on the same pocket and ligand. Both draw the
JAX package's random parameters for the micro detector, so the `.pm`
nodes must be equal (type, score, centre and radius within 1e-5) and the
CSVs within rtol 2e-5 / atol 1e-4, ligand by ligand. Every `*_torch.py`
example imports with JAX absent and runs nothing when imported.
`download_pretrained_model` writes the file where it is asked to through a
stub gdown (both packages), and without gdown raises naming `GDRIVE_URL`.
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["end_to_end_torch", "get_cache_tacogfn_torch", "get_cache_sbddreward_torch",
            "train_example_torch"]


def _load(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _scores(path: Path) -> dict[str, float]:
    with open(path) as f:
        return {Path(r["path"]).name: float(r["score"]) for r in csv.DictReader(f)}


def test_end_to_end_matches_jax_example(tmp_path, monkeypatch):
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path / "home"))  # no checkpoint: random
    monkeypatch.delenv("PMNET_TPU_WEIGHT", raising=False)
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

    port = _load("end_to_end_torch")
    out = tmp_path / "port"
    assert port.main(port.build_parser().parse_args(
        ["--device", "cpu", "--out_dir", str(out)])) == 0
    jax_example = _load("end_to_end")
    jax_out = tmp_path / "jax"
    assert jax_example.main(jax_example.build_parser().parse_args([
        "--protein", str(out / "site" / "pocket.pdb"), "--ref_ligand",
        str(out / "site" / "ligand.pdb"), "--out_dir", str(jax_out)])) == 0

    got = PharmacophoreModel.load(str(out / "pocket_model.pm"))
    want = PharmacophoreModel.load(str(jax_out / "pocket_model.pm"))
    assert len(got.nodes) == len(want.nodes) >= 4
    for a, b in zip(got.nodes, want.nodes):
        assert (a.type, a.interaction_type) == (b.type, b.interaction_type)
        assert a.score == pytest.approx(b.score, abs=1e-5)
        assert a.radius == pytest.approx(b.radius, abs=1e-5)
        assert a.center == pytest.approx(b.center, abs=1e-5)
    scores, jax_scores = _scores(out / "scores.csv"), _scores(jax_out / "scores.csv")
    assert scores.keys() == jax_scores.keys() and len(scores) == 60
    for name, s in jax_scores.items():
        assert scores[name] == pytest.approx(s, rel=2e-5, abs=1e-4), name
    assert sum(s > 0 for s in scores.values()) >= 30


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_without_jax_and_run_nothing(name):
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["pharmaconet_tpu"] = None
        runpy.run_path({str(REPO / "examples" / f"{name}.py")!r}, run_name="imported")
        assert not any(m == "jax" or m.startswith(("jax.", "pharmaconet_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


def test_examples_take_device():
    """Each example's --device defaults to cuda (end_to_end_torch's parser;
    the others parse under their __main__ guard)."""
    args = _load("end_to_end_torch").build_parser().parse_args([])
    assert args.device == "cuda" and args.protein is None and args.n_ligands == 60
    for name in EXAMPLES[1:]:
        assert '"--device", default="cuda"' in (REPO / "examples" / f"{name}.py").read_text()


def _stub_gdown(calls: list):
    def download(url, output, quiet=False):
        calls.append((url, output, quiet))
        Path(output).write_bytes(b"checkpoint")
        return output

    return types.SimpleNamespace(download=download)


@pytest.mark.parametrize("package", ["pharmaconet_tpu_torch", "pharmaconet_tpu"])
def test_download_pretrained_model_with_stub_gdown(tmp_path, monkeypatch, package):
    """The file lands where it is asked for (directories made), once; the
    lookup ends in the download into $PMNET_TPU_HOME/model.tar."""
    import importlib

    mod = importlib.import_module(f"{package}.utils.download_weight")
    calls: list = []
    monkeypatch.setitem(sys.modules, "gdown", _stub_gdown(calls))
    target = tmp_path / "a" / "b" / "model.tar"
    assert mod.download_pretrained_model(target, verbose=False) == target
    assert target.read_bytes() == b"checkpoint"
    assert calls == [(mod.GDRIVE_URL, str(target), True)]
    assert mod.download_pretrained_model(target, verbose=False) == target
    assert len(calls) == 1

    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("PMNET_TPU_WEIGHT", raising=False)
    assert mod.resolve_weight_path(None, verbose=False) == tmp_path / "home" / "model.tar"
    assert (tmp_path / "home" / "model.tar").exists() and len(calls) == 2


def test_download_without_gdown_raises(tmp_path, monkeypatch):
    """Without gdown: RuntimeError naming GDRIVE_URL and the path, and no
    directory made."""
    from pharmaconet_tpu_torch.utils.download_weight import (
        GDRIVE_URL,
        download_pretrained_model,
        resolve_weight_path,
    )

    monkeypatch.setitem(sys.modules, "gdown", None)
    target = tmp_path / "sub" / "model.tar"
    with pytest.raises(RuntimeError, match=GDRIVE_URL.replace("?", r"\?")) as err:
        download_pretrained_model(target)
    assert str(target) in str(err.value) and not target.parent.exists()
    monkeypatch.setenv("PMNET_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("PMNET_TPU_WEIGHT", raising=False)
    with pytest.raises(RuntimeError, match="gdown is not installed"):
        resolve_weight_path(None)
    assert not (tmp_path / "home").exists()


def test_example_parser_matches_jax_flags():
    """end_to_end_torch.py keeps end_to_end.py's flags, plus --device."""
    def flags(parser: argparse.ArgumentParser) -> set[str]:
        return {s for a in parser._actions for s in a.option_strings}

    port = flags(_load("end_to_end_torch").build_parser())
    jax_flags = flags(_load("end_to_end").build_parser())
    assert port == jax_flags | {"--device"}
