"""The scale demos (`pharmaconet_tpu_torch/probes/demo_*.py`) at tiny sizes
on the CPU.

The three demos run once, side by side, each in its own process with
`--device cpu` (they run the port's CLIs and trainer workers in
subprocesses of their own): `demo_1m_screen` at 4,096 ligands (1,024
distinct, batches of 512), `demo_real_screen` at 48 fragment SMILES x 2
conformers (batches of 4; embedded by the numpy backend, which
`test_torch_embed.py` holds the torch backend to), `demo_train_scale` at the micro widths (4
training pockets, 4 steps killed after step 3, a 3-pocket cache build).
Each screen is sent a real SIGKILL mid-run and resumed; its resumed CSV is
byte-equal to an uninterrupted screen's. The stored screen's CSV equals the
JAX screening CLI's on the same store within rtol 2e-5 / atol 1e-4. The
JAX package's own scale records in the repo root stay untouched.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pharmaconet_tpu_torch.probes import demo_real_screen, scale

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-4
RECORDS = ("SCALE_1M.json", "SCALE_1M_v2store.json", "SCALE_REAL.json", "TRAIN_SCALE.json")
DEMOS = {
    "demo_1m_screen": ["--n", "4096", "--distinct", "1024", "--batch_size", "512"],
    "demo_real_screen": ["--n", "48", "--num_conformers", "2", "--batch_size", "4",
                         "--spot_checks", "16", "--embed_backend", "numpy"],
    "demo_train_scale": ["--arch", "micro", "--n", "3", "--pockets", "4", "--ligands", "4",
                         "--steps", "4", "--kill_step", "3", "--batch_size", "2"],
}


def _digests() -> dict[str, str]:
    return {name: hashlib.sha256((REPO / name).read_bytes()).hexdigest() for name in RECORDS}


@pytest.fixture(scope="module")
def records_before():
    return _digests()


@pytest.fixture(scope="module")
def demos(records_before, tmp_path_factory):
    """{demo: (exit code, report, work directory, output)}. The demos run
    side by side from a directory outside the repo; once demo_1m_screen's
    store is written, the JAX screening CLI screens it here meanwhile
    (`jax.csv` beside it)."""
    from pharmaconet_tpu.cli.screening import build_parser, main

    root = tmp_path_factory.mktemp("scale_demos")
    procs = {}
    for name, extra in DEMOS.items():
        threads = "4" if name == "demo_1m_screen" else "2"  # the longest gets more cores
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"pharmaconet_tpu_torch.probes.{name}", *extra,
             "--device", "cpu", "--work_dir", str(root / name), "--keep"],
            cwd=root, env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": threads},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    store = root / "demo_1m_screen" / "tiles"
    while not (store / "meta.json").exists() and procs["demo_1m_screen"].poll() is None:
        time.sleep(0.1)
    if (store / "meta.json").exists():  # written last
        assert main(build_parser().parse_args([
            "-p", str(store.parent / "model.pm"), "--library_tiles", str(store),
            "-o", str(store.parent / "jax.csv")])) == 0
    out = {}
    for name, proc in procs.items():
        output, _ = proc.communicate(timeout=600)
        report = json.loads((root / name / "report.json").read_text())
        out[name] = (proc.returncode, report, root / name, output)
    return out


def _ok(demos, name) -> dict:
    rc, report, _, output = demos[name]
    assert rc == 0 and report["ok"], output[-4000:]
    assert json.loads(output.strip().splitlines()[-1]) == report  # the report is the last line
    return report


def _screen_held(report: dict, work: Path, n: int) -> None:
    screen = report["screen"]
    assert screen["phase_a"]["killed"] and screen["phase_a"]["rc"] == -9
    assert 0 < screen["phase_a"]["rows_in_partial"] < n
    assert screen["phase_b"]["rows"] == n - screen["phase_a"]["rows_in_partial"]
    assert screen["rows"] == n and screen["resumed_csv_byte_equal"]
    assert (work / "scores.csv").read_bytes() == (work / "scores_uninterrupted.csv").read_bytes()
    assert not (work / "scores.csv.partial").exists()
    assert all(screen[k]["peak_rss_gib"] > 0 for k in ("phase_a", "phase_b", "uninterrupted"))


def test_demo_1m_screen_kill_resume_and_replicas(demos):
    report = _ok(demos, "demo_1m_screen")
    _screen_held(report, demos["demo_1m_screen"][2], 4096)
    assert report["distinct"] == 1024 and report["store_version"] == 3
    assert report["prepack"]["store_meta"]["n_ligands"] == 4096
    assert report["prepack"]["bytes_per_ligand"] > 0
    assert report["replica_check"]["checked"] > 1000
    # the CLIs ran the plain versions on the CPU: no kernel launched
    assert report["launches"] == {}


def test_demo_1m_screen_csv_equals_jax_cli(demos):
    """The resumed CSV against pharmaconet_tpu's screening CLI on the same
    store files, ligand by ligand."""
    work = demos["demo_1m_screen"][2]
    _ok(demos, "demo_1m_screen")
    got, want = scale.read_scores(work / "scores.csv"), scale.read_scores(work / "jax.csv")
    assert got.keys() == want.keys() and len(got) == 4096
    names = sorted(want)
    np.testing.assert_allclose([got[n] for n in names], [want[n] for n in names],
                               rtol=RTOL, atol=ATOL)


def test_screen_that_ends_before_the_kill_fails(tmp_path):
    """A screen that ends before <out>.partial reaches the kill threshold
    (here a stand-in that writes one row and exits) fails the demo rather
    than record a kill that did not happen."""
    def cmd(out):
        return [sys.executable, "-c", f"open({str(out)!r} + '.partial', 'w').write('0,a,1.5\\n')"]

    with pytest.raises(scale.DemoError, match="nothing was killed"):
        scale.kill_and_resume("screen", cmd, tmp_path / "s.csv", 48, 0.4, tmp_path)
    assert (tmp_path / "s.csv.partial").read_text() == "0,a,1.5\n"


def test_demo_real_screen_spot_checks(demos):
    report = _ok(demos, "demo_real_screen")
    _screen_held(report, demos["demo_real_screen"][2], 48)
    check = report["spot_check"]
    assert check["sampled"] == 16 and check["checked"] == 16 and check["failed"] == 0
    assert check["node_pos_max_diff"] == 0.0  # re-embedded conformers equal the packed ones
    assert report["smiles_prepack"]["chunks"][0]["rc"] == 0
    assert report["tiles_prepack"]["store_meta"]["n_ligands"] == 48


def test_spot_check_catches_a_changed_score(demos):
    from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.scoring.library import load_library

    work = demos["demo_real_screen"][2]
    _ok(demos, "demo_real_screen")
    entries = enumerate_fragment_smiles(48, seed=11)
    model = PharmacophoreModel.load(str(work / "model.pm"))
    scores = scale.read_scores(work / "scores.csv")
    packed, names = load_library(work / "lib.npz")
    library = dict(zip(names, packed))
    indices = [3, 30]
    name = entries[30][0]
    scores[name] += max(1.0, 0.01 * abs(scores[name]))
    check = demo_real_screen.spot_check(model, entries, indices, scores, library, 2, "cpu",
                                        "numpy")
    assert check["checked"] == 2 and check["failed"] == 1
    assert [m["name"] for m in check["misses"]] == [name]


def test_demo_train_scale_resume_and_cache(demos):
    report = _ok(demos, "demo_train_scale")
    train = report["train"]
    runs = train["runs"]
    assert runs["killed"]["steps"] == 3 and train["stages"]["killed"]["rc"] == 77
    assert runs["resumed"]["steps"] == 1 and runs["resumed"]["optimizer_count"] == 4
    assert runs["uninterrupted"]["steps"] == 4
    assert train["resumed_vs_uninterrupted_max_diff"] <= 1e-6
    cache = report["cache_build"]
    assert cache["pockets"] == 3 and cache["serial_pockets"] == 3
    assert cache["shared_keys_equal"] and cache["sharded_pockets_per_hour"] > 0


def test_repo_records_unchanged(records_before, demos):
    assert all(rc == 0 for rc, *_ in demos.values())
    assert _digests() == records_before
