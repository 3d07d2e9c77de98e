"""Import rules of the PyTorch/CUDA port.

The port imports with JAX absent, imports nothing of `pharmaconet_tpu`,
builds nothing and imports no triton when imported, and never moves to the
CPU on its own: asking for CUDA without a card raises.
"""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pharmaconet_tpu_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_reference_package_imports(rel):
    for name in _imported_modules(REPO / rel):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "pharmaconet_tpu"), (rel, name)


def test_every_module_imports_without_jax_and_builds_nothing():
    code = textwrap.dedent("""
        import ctypes, importlib, pkgutil, subprocess, sys
        sys.modules["jax"] = None
        sys.modules["pharmaconet_tpu"] = None
        import numpy, scipy.ndimage, torch  # third-party imports may run tools
        calls = []  # any compiler run or library load by the port's imports
        run, cdll = subprocess.run, ctypes.CDLL
        subprocess.run = lambda *a, **k: calls.append(a) or run(*a, **k)
        ctypes.CDLL = lambda *a, **k: calls.append(a) or cdll(*a, **k)
        import pharmaconet_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, "pharmaconet_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        from pharmaconet_tpu_torch import native
        from pharmaconet_tpu_torch.ops import screen_cuda, voxelize_cuda
        assert calls == [], calls
        assert native._state == {} and screen_cuda._lib is None and voxelize_cuda._lib is None
        assert "triton" not in sys.modules
        assert not any(m == "jax" or m.startswith(("jax.", "pharmaconet_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    stored_route = {f"pharmaconet_tpu_torch.{m}" for m in (
        "scoring.screen_v3", "scoring.leaf_tree", "scoring.tiled_store", "cli.prepack",
        "cli.screening", "ops.screen_cuda", "ops.screen_ref", "native")}
    assert stored_route <= names, stored_route - names
    modeling = {f"pharmaconet_tpu_torch.{m}" for m in (
        "chem.pdb", "chem.protein", "chem.pocket", "chem.templates", "data.featurizer",
        "ops.voxelize", "ops.voxelize_cuda", "ops.postprocess", "network.layers",
        "network.swin3d", "network.fpn", "network.heads", "network.model", "network.convert",
        "module", "utils.visualize", "cli.modeling")}
    assert modeling <= names, modeling - names
    probes = {f"pharmaconet_tpu_torch.probes.{m}" for m in (
        "prep", "timing", "probe_pallas_screen", "probe_fused_split", "probe_kernel_r3",
        "sass_compare")}
    assert probes <= names, probes - names
    smiles = {f"pharmaconet_tpu_torch.{m}" for m in (
        "chem.smiles", "chem.fragments", "chem.embed", "scoring.parse_pool", "scoring.library",
        "scoring.ligand", "pharmacophore.model")}
    assert smiles <= names, smiles - names
    features_and_proxies = {f"pharmaconet_tpu_torch.{m}" for m in (
        "api", "cli.feature_extraction", "utils.rcsb", "network.necks", "proxy", "proxy.data",
        "proxy.gnn", "proxy.convert", "proxy.tacogfn", "proxy.sbddreward", "proxy.base",
        "proxy.proxies")}
    assert features_and_proxies <= names, features_and_proxies - names
    serving_and_training = {f"pharmaconet_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.proxy", "training", "training.config",
        "training.affinity_model", "training.convert", "training.dataset", "training.train_step",
        "training.trainer")}
    assert serving_and_training <= names, serving_and_training - names
    sharded = {f"pharmaconet_tpu_torch.{m}" for m in (
        "parallel.screening", "parallel.modeling", "utils.profiling", "cli.convert_weights")}
    assert sharded <= names, sharded - names


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, resolve_device
    from pharmaconet_tpu_torch.synthetic import make_synthetic_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchScreener(make_synthetic_model(num_clusters=4, seed=0))  # default device


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors; anything else
    it cannot launch raises instead of falling back."""
    from pharmaconet_tpu_torch.ops import screen_cuda

    meta = [torch.empty(s, device="meta") for s in ((1, 12, 64), (1, 1024), (8, 1024),
                                                     (8, 1024), (8, 1024))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        screen_cuda.gaussian_phase(*meta)
    mixed = [torch.empty(1, 12, 64), torch.empty(1, 1024, device="meta")]
    with pytest.raises(ValueError, match="several devices"):
        screen_cuda.score_tiles_fused_rows(*mixed, torch.empty(1), torch.empty(1), 1, 2)


@pytest.mark.parametrize("isolated", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_card(tmp_path, isolated):
    """chip_smoke.py exits non-zero and prints no result without a card, and
    alone in a directory without the rest of the repo."""
    if torch.cuda.is_available() and not isolated:
        pytest.skip("a CUDA device is visible")
    script = REPO / "chip_smoke.py"
    if isolated:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
