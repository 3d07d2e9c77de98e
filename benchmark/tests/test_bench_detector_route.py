"""The modeling cell through the harness on the CPU at the small size: its
files are found by name, it reports its metrics, the screening cells'
metrics stay as they were, and `correct` comes out false when the timed
path is broken underneath."""

import json
import time

import numpy as np
import pytest

import harness
import model_flops
from conftest import BENCH_DIR, ROOT
from detector_cells import TINY_DETECTOR, make_tiny_detector

from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

CELL = "detector.pocket3k-p8"
SCREENING = {
    "pm20.stored-c8": (["card_ms_per_klig", "setup_s"],
                       ["screen_lig_per_s.card", "copy_gbps.card", "kernels_roofline.card",
                        "h2d_host_ms.card"]),
    "pm20.stored-c16": (["screen_lig_per_s", "setup_s"],
                        ["store_load_ms", "copy_gbps", "kernels_roofline", "tail_ms",
                         "device_idle", "copy_out_ms", "h2d_host_ms", "launch_ms",
                         "prefetch_wait_ms", "idle_copy_out", "idle_h2d"]),
}
PER_LAYER = ["parse_ms", "trunk_ms", "segment_ms", "graph_ms", "kernels_mfu",
             "device_idle.model"]


@pytest.fixture
def tiny_detector(tmp_path):
    return make_tiny_detector(tmp_path)


def _names(spec, cell, trace):
    return [m["name"] for m in harness.cell_metrics(spec, cell, trace)]


def test_the_modeling_cell_is_found_by_name():
    found = harness.find_cell(BENCH_DIR, CELL)
    assert found.route == BENCH_DIR / "routes" / "modeling.py"
    assert found.traffic["route"] == "modeling"
    assert found.config["name"] == "pmnet-detector"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert _names(spec, CELL, False) == ["setup_s", "pockets_per_s", "modeling_mfu"]
    assert _names(spec, CELL, True) == PER_LAYER
    assert harness.metric_path(BENCH_DIR, "device_idle.model") == \
        BENCH_DIR / "metrics" / "device_idle.py"
    for name in PER_LAYER + ["pockets_per_s", "modeling_mfu"]:
        assert harness.metric_path(BENCH_DIR, name).is_file()


def test_the_screening_cells_report_what_they_did():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (e2e, layers) in SCREENING.items():
        assert sorted(_names(spec, cell, False)) == sorted(e2e)
        assert sorted(_names(spec, cell, True)) == sorted(layers)


def test_the_modeling_readers_read_their_run_s_record():
    """An untraced run's records carry no `work`: the modeling readers take
    what this run's check recorded of its passes, and read nothing in a
    run of another route (another count of passes or items)."""
    mfu = harness.load_module(BENCH_DIR / "metrics" / "modeling_mfu.py", "mfu")
    rate = harness.load_module(BENCH_DIR / "metrics" / "pockets_per_s.py", "rate")
    model_flops.record_pass(3, 24, int(67e12))
    records = dict(passes=3, items=24, window_s=6.0)
    assert mfu.read(records) == pytest.approx(50.0)
    assert rate.read(records) == 4.0
    screening = dict(passes=3, items=3 * 131072, window_s=6.0)
    assert mfu.read(screening) is None and rate.read(screening) is None


def test_a_cpu_rehearsal_of_the_cell(tiny_detector):
    """Set-up, passes and the check, untraced and traced."""
    result, lines = harness.run_cell(tiny_detector, TINY_DETECTOR, 2**31 + 41, 0.3, False,
                                     "cpu", time.perf_counter())
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] == 2 * result["info"]["passes"]
    assert set(result["metrics"]) == {"setup_s", "pockets_per_s", "modeling_mfu"}
    assert result["metrics"]["modeling_mfu"]["value"] > 0
    assert list(result["checks"]) == ["pockets_missing", "tokens_mismatch", "token_score_share",
                                      "keep_mismatch", "density_tol_share", "flip_voxels",
                                      "nodes_mismatch"]
    result, lines = harness.run_cell(tiny_detector, TINY_DETECTOR, 2**31 + 42, 0.3, True,
                                     "cpu", time.perf_counter())
    assert result["correct"], lines
    # no card: the device's metrics have nothing to read
    assert set(result["metrics"]) == {"parse_ms", "trunk_ms", "segment_ms", "graph_ms"}


CREATE = PharmacoNet.create_density_maps
POSTPROCESS = PharmacoNet.postprocess
HEADS = PharmacoNet.heads


def _stale():
    """Each pocket gets the previous pocket's hotspots."""
    last = {}

    def create(self, data):
        infos = CREATE(self, data)
        prev = last.get(id(self), infos)
        last[id(self)] = infos
        return prev
    return "create_density_maps", create


def _half():
    """Half of each chunk's maps left out, the mean of the rest in their place."""
    def post(self, out, hot, logits, valid):
        density, sparse = POSTPROCESS(self, out, hot, logits, valid)
        k = int(valid.sum())
        if k > 1:
            density = density.clone()
            density[k // 2: k] = density[: k // 2].mean(0)
        return density, None
    return "postprocess", post


def _altered_score():
    """One token's score altered where the heads produce it."""
    def heads(self, data, pyramid, occupancy):
        out = HEADS(self, data, pyramid, occupancy)
        out["abs_scores"] = out["abs_scores"].clone()
        out["abs_scores"][0] += 1e-3
        return out
    return "heads", heads


def _altered_voxel():
    """One voxel of each chunk's first map altered where it is produced."""
    def post(self, out, hot, logits, valid):
        density, _ = POSTPROCESS(self, out, hot, logits, valid)
        density = density.clone()
        flat = density[0].reshape(-1)
        flat[int(flat.argmax())] += 1e-3
        return density, None
    return "postprocess", post


def _dropped_token():
    """The last token of each pocket left out where the parse produces it."""
    def parse(self, *a, **k):
        data = PARSE(self, *a, **k)
        data.token_valid[int(data.token_valid.sum()) - 1] = False
        return data
    return "parse", parse


def _dropped_node():
    """The last node of each model left out of the `.pm` written."""
    def getstate(self):
        state = GETSTATE(self)
        state["nodes"] = state["nodes"][:-1]
        return state
    return PharmacophoreModel, "__getstate__", getstate


PARSE = PharmacoNet.parse
GETSTATE = PharmacophoreModel.__getstate__


@pytest.mark.parametrize("fault", [None, _stale, _half, _altered_score, _altered_voxel,
                                   _dropped_token, _dropped_node],
                         ids=["sound", "stale", "half", "altered_score", "altered_voxel",
                              "dropped_token", "dropped_node"])
def test_a_broken_path_is_not_correct(tiny_detector, monkeypatch, fault):
    if fault is not None:
        planted = fault()
        monkeypatch.setattr(*(planted if len(planted) == 3 else (PharmacoNet, *planted)))
    result, lines = harness.run_cell(tiny_detector, TINY_DETECTOR, 2**31 + 43, 0.2, False,
                                     "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), lines
    assert (result["failed"] > 0) is (fault is not None)


def test_distributions_keep_about_the_asked_share():
    from routes.modeling import calibrate_distributions

    rng = np.random.default_rng(5)
    scores = [(rng.uniform(0.1, 0.9, 300).astype(np.float32), rng.integers(0, 10, 300))
              for _ in range(4)]
    dists = calibrate_distributions(scores, 20)
    kept = 0
    for a, t in scores:
        for c, d in enumerate(dists):
            rel = np.searchsorted(d, a[t == c], "left") / len(d)
            kept += int((rel >= [0.85, 0.7, 0.7, 0.7, 0.7, 0.85, 0.85, 0.7, 0.7, 0.85][c]).sum())
            assert not np.isin(a[t == c], d).any()
    assert 60 <= kept <= 100  # 20 a pocket
