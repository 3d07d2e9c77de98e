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
ROOT_ENTRY_POINTS = ["bench_torch.py", "feature_extraction_torch.py", "modeling_torch.py",
                     "prepack_torch.py", "screening_torch.py"]
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + [
    "chip_smoke.py", *ROOT_ENTRY_POINTS, *sorted(p.relative_to(REPO).as_posix()
                                                 for p in (REPO / "examples").glob("*_torch.py"))]
BLOCK_JAX = 'import sys; sys.modules["jax"] = None; sys.modules["pharmaconet_tpu"] = None; '


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
    battery = {f"pharmaconet_tpu_torch.{m}" for m in (
        "utils.crosscheck", "utils.download_weight", "cli.verify_checkpoint", "probes.chip_ci")}
    assert battery <= names, battery - names
    assert "pharmaconet_tpu_torch.probes.probe_reproducible" in names
    scale_demos = {f"pharmaconet_tpu_torch.{m}" for m in (
        "ops.launch_log", "probes.scale", "probes.demo_1m_screen", "probes.demo_real_screen",
        "probes.demo_train_scale")}
    assert scale_demos <= names, scale_demos - names
    stored_probes = {f"pharmaconet_tpu_torch.probes.{m}" for m in (
        "stored_route", "probe_leaf_phases", "probe_shape_sweep", "probe_sparse_wire",
        "probe_sparse_split", "probe_gather_variants", "probe_scan_share", "probe_seg_bf16",
        "probe_conv_ladder", "probe_dfs_stats", "probe_layout_stats")}
    assert stored_probes <= names, stored_probes - names


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


@pytest.mark.parametrize("rel", ROOT_ENTRY_POINTS)
def test_root_entry_point_help_without_jax(rel):
    """bench_torch.py and the *_torch.py shims answer --help with JAX
    absent."""
    code = BLOCK_JAX + (f"import runpy; sys.argv = [{rel!r}, '--help']; "
                        f"runpy.run_path({rel!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:"), out.stdout


def test_console_scripts_resolve_without_jax():
    """Each pmnet-torch-* script of pyproject.toml names an existing
    `entrypoint` of the port's CLI that imports with JAX absent, one for
    each pmnet-tpu-* script."""
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    torch_scripts = {k: v for k, v in scripts.items() if k.startswith("pmnet-torch-")}
    assert sorted(k.replace("-tpu-", "-torch-") for k in scripts if k.startswith("pmnet-tpu-")) \
        == sorted(torch_scripts)
    code = BLOCK_JAX + textwrap.dedent(f"""
        import importlib
        for target in {sorted(torch_scripts.values())!r}:
            module, attr = target.split(":")
            assert module.startswith("pharmaconet_tpu_torch.cli."), target
            assert attr == "entrypoint" and callable(getattr(importlib.import_module(module), attr))
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_bench_torch_runs_without_jax():
    """bench_torch.py imports and runs a kernel-mode engine (on the CPU)
    with JAX and the JAX package absent."""
    code = BLOCK_JAX + textwrap.dedent("""
        import bench_torch
        r = bench_torch.run("kernel", "v3-leaf", batch_size=16, iters=1, device="cpu",
                            clusters=4)
        assert r["correct"] is True, r
        assert not any(m == "jax" or m.startswith(("jax.", "pharmaconet_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
