"""The harness finds every piece of a cell by name, and takes a new
configuration, traffic mix or metric from new files and entries alone."""

import json
import time

import harness
from conftest import BENCH_DIR, ROOT, TINY_CELL

CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def test_every_cell_is_found_by_name():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == CONTRACT_KEYS
    for cell in spec["workloads"]:
        found = harness.find_cell(BENCH_DIR, cell["name"])
        assert found.route.is_file()
        assert found.config["name"] == cell["config"]
        for m in harness.cell_metrics(spec, cell["name"], False) + harness.cell_metrics(
                spec, cell["name"], True):
            assert harness.metric_path(BENCH_DIR, m["name"]).is_file()
        names = {m["name"] for m in harness.cell_metrics(spec, cell["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        layers = harness.cell_metrics(spec, cell["name"], True)
        assert layers and {m["moves"] for m in layers} <= names
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_split_metric_reads_with_its_base():
    """`copy_gbps.card` is copy_gbps's quantity in cells whose end-to-end
    metric it moves is another: it reads with `metrics/copy_gbps.py`."""
    metrics = BENCH_DIR / "metrics"
    assert harness.metric_path(BENCH_DIR, "copy_gbps.card") == metrics / "copy_gbps.py"
    assert harness.metric_path(BENCH_DIR, "card_ms_per_klig") == metrics / "card_ms_per_klig.py"
    tl = {"device": [("k", 0, 4_000_000, False), ("Memcpy HtoD", 2_000_000, 6_000_000, True)],
          "spans": [("bench.window", 0, 10_000_000)]}
    reader = harness.load_module(metrics / "card_ms_per_klig.py", "card")
    assert reader.read(dict(timeline=tl, items=2000)) == 3.0  # 6 ms busy, 2 klig
    assert reader.read(dict(timeline=None, items=2000)) is None


def test_metrics_of_a_cell():
    spec = {
        "end_to_end": [{"name": "a", "moves": None}, {"name": "b", "workloads": ["y"]}],
        "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                      {"name": "r", "moves": "a", "workloads": ["y"]}],
    }
    assert [m["name"] for m in harness.cell_metrics(spec, "x", False)] == ["a"]
    assert [m["name"] for m in harness.cell_metrics(spec, "x", True)] == ["p"]
    assert [m["name"] for m in harness.cell_metrics(spec, "y", True)] == ["p", "q", "r"]


def test_new_config_traffic_and_metric_files_are_picked_up(tiny_bench):
    """A second configuration, a second mix and a new per-layer metric,
    added as files and entries only, run and report."""
    root = tiny_bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((tiny_bench / "configs" / "tiny.json").read_text())
    (tiny_bench / "configs" / "tiny40.json").write_text(
        json.dumps(dict(config, name="tiny40", num_clusters=40)))
    traffic = json.loads((tiny_bench / "traffic" / "tiny-c4.json").read_text())
    (tiny_bench / "traffic" / "tiny-c2.json").write_text(
        json.dumps(dict(traffic, conformers=2, check_sample=40)))
    (tiny_bench / "metrics" / "passes_run.py").write_text(
        "def read(records):\n    return float(records['passes'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="tiny40",
                                file="benchmark/configs/tiny40.json"))
    spec["workloads"].append(dict(name="tiny40.c2", config="tiny40", traffic="tiny-c2",
                                  chips=1, why="added"))
    spec["per_layer"].append(dict(name="passes_run", unit="passes", better="higher",
                                  source="host_clock", layer="harness",
                                  moves="screen_lig_per_s", workloads=["tiny40.c2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, lines = harness.run_cell(tiny_bench, "tiny40.c2", 7, 0.2, True, "cpu",
                                     time.perf_counter())
    assert result["correct"], lines
    assert result["metrics"]["passes_run"]["value"] == result["info"]["passes"] >= 1
    result, _ = harness.run_cell(tiny_bench, TINY_CELL, 8, 0.2, False, "cpu",
                                 time.perf_counter())
    assert result["correct"]
    assert set(result["metrics"]) == {"screen_lig_per_s", "setup_s"}


def test_result_line_on_the_cpu(tiny_bench):
    t0 = time.perf_counter()
    result, lines = harness.run_cell(tiny_bench, TINY_CELL, 2**31 + 11, 0.3, False,
                                     "cpu", t0)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 192 * result["info"]["passes"]
    m = result["metrics"]
    assert 0 < m["setup_s"]["value"] < time.perf_counter() - t0
    assert m["screen_lig_per_s"]["value"] > 0
    assert lines == [f"check {n} {c['value']} limit {c['limit']}"
                     for n, c in result["checks"].items()]
    assert result["checks"]["score_tol_share"]["value"] < 0.1
