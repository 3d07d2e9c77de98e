"""A tiny copy of the modeling cell for runs of the harness on the CPU:
grid 16, embed 24, depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 4, two
pockets of about 400 atoms a pass, chunks of 4 hotspots."""

import json
import shutil

from conftest import BENCH_DIR, ROOT

TINY_DETECTOR = "tiny.detector"
SMALL = dict(grid_dim=16, embed_dim=24, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
             fpn_channels=24, token_feature_dim=48, segmentation_chunk=4,
             hotspots_per_pocket=5, host_threads=2)
SMALL_TRAFFIC = dict(pockets=2, atoms_per_pocket=400, cavity_radius=1.0, outer_radius=14.0,
                     center_range=5.0)


def small_config() -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / "pmnet-detector.json").read_text())
    return dict(cfg, name="tinydet", **SMALL)


def small_traffic() -> dict:
    traffic = json.loads((BENCH_DIR / "traffic" / "pockets-3k-p8.json").read_text())
    return dict(traffic, **SMALL_TRAFFIC)


def make_tiny_detector(tmp_path):
    """The benchmark's routes and metrics beside a BENCHMARK.json whose one
    cell is the modeling cell at the small size, with the cell's metrics.
    Returns the copy's benchmark folder."""
    bench = tmp_path / "benchmark"
    for sub in ("routes", "metrics"):
        shutil.copytree(BENCH_DIR / sub, bench / sub)
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    (bench / "configs" / "tinydet.json").write_text(json.dumps(small_config()))
    (bench / "traffic" / "tiny-p2.json").write_text(json.dumps(small_traffic()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = "detector.pocket3k-p8"
    spec["configs"] = [dict(name="tinydet", source="tiny", file="benchmark/configs/tinydet.json",
                            reduced=[], why="tiny")]
    spec["workloads"] = [dict(name=TINY_DETECTOR, config="tinydet", traffic="tiny-p2", chips=1,
                              why="tiny")]
    spec["end_to_end"] = [dict(m, workloads=[TINY_DETECTOR]) for m in spec["end_to_end"]
                          if real in m.get("workloads", [real])]
    spec["per_layer"] = [dict(m, workloads=[TINY_DETECTOR]) for m in spec["per_layer"]
                         if real in m.get("workloads", [])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
