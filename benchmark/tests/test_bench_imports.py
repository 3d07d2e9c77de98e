"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the program either."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT, TINY_CELL

JAX_NAMES = {"jax", "jaxlib", "flax", "pharmaconet_tpu"}
REFERENCE = ["screen_reference.py", "ligand_traffic.py", "roofline.py",
             *sorted(f"ligchem/{p.name}" for p in (BENCH_DIR / "ligchem").glob("*.py"))]


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_name_no_jax_module():
    files = [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not set(_imported(p)) & JAX_NAMES, p
    for name in REFERENCE:
        assert not {m for m in _imported(BENCH_DIR / name)
                    if m.startswith("pharmaconet")}, name


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cpu_run_loads_no_jax_module(tiny_bench):
    code = (
        "import sys, time, json; "
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]; "
        "import harness; "
        f"r, _ = harness.run_cell(__import__('pathlib').Path({str(tiny_bench)!r}), "
        f"{TINY_CELL!r}, 5, 0.2, True, 'cpu', time.perf_counter()); "
        "assert r['correct']; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    names = _modules_after(code)
    assert "pharmaconet_tpu_torch" in names
    assert not names & JAX_NAMES
    import harness

    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json; "
        f"sys.path[:0] = [{str(BENCH_DIR)!r}]; "
        "import screen_reference, ligand_traffic, roofline, control; "
        "m = screen_reference.Model(ligand_traffic.model_state(20, 0), "
        "{t: 1.0 for t in ligand_traffic.TYPES}); "
        "lib = ligand_traffic.fragment_ligands(4, 2, 1); "
        "[screen_reference.ligand_score(m, lib.ligand(i)) for i in range(4)]; "
        "roofline.screening_work(m, lib); "
        "print(json.dumps(sorted({x.split('.')[0] for x in sys.modules})))"
    )
    names = _modules_after(code)
    assert not {n for n in names if n.startswith("pharmaconet")}
    assert "torch" not in names


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """run.py prints no result and exits non-zero where the cell's card is
    missing, and from a tree that holds only BENCHMARK.json and the
    benchmark's folder (no program to import)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would start")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 3 and out.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = (
        "import sys, time; "
        f"sys.path[:0] = [{str(tmp_path / 'benchmark')!r}, {str(tmp_path)!r}]; "
        "import harness, pathlib; "
        f"harness.run_cell(pathlib.Path({str(tmp_path / 'benchmark')!r}), {cell!r}, "
        "1, 1.0, False, 'cpu', time.perf_counter())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "pharmaconet_tpu_torch" in out.stderr
