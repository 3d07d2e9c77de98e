"""The port's span recorder (`utils/profiling.py`) and the stored route's
spans and counters, on the CPU.

The recorder: with no profiler recording a span is a shared no-op that
never enters `record_function`; under `torch.profiler` spans from two
threads carry their name, parent, thread and batch index, lie within 1 ms
of the profiler's own events, and counts add up; `trace()` writes the
spans' JSON beside the Chrome trace. The stored route: a v3 store
screened through `screen_tiles` under the profiler records one
`pmnet.dispatch` per batch with its copy-out and pageable-copy children,
byte counters equal to what `_to_device` was handed, and the same scores
bit for bit as the screen with no profiler.
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.cli import screening as cli
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import tiled_store as tts
from pharmaconet_tpu_torch.utils import profiling

BATCH = 16


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("pmnet.a") is profiling.span("pmnet.b", batch=3)
    with profiling.span("pmnet.a", batch=1):
        with profiling.span("pmnet.a.b"):
            profiling.count("pmnet.n", 5)
    assert profiling.spans() == [] and profiling.counts() == {}


def test_spans_from_two_threads_under_the_profiler():
    """Nested spans on the main thread and on a second thread: names,
    parents, threads, batch indices (a child without its own takes its
    parent's); the main thread's spans within 1 ms of the profiler's
    events (the profiler follows the thread that started it)."""
    both_open = threading.Barrier(2, timeout=30)

    def worker():
        with profiling.span("pmnet.w.outer", batch=7):
            with profiling.span("pmnet.w.inner"):
                both_open.wait()

    with _profiled() as prof:
        t = threading.Thread(target=worker, name="pmnet-test-worker")
        with profiling.span("pmnet.m.outer", batch=3):
            t.start()
            with profiling.span("pmnet.m.inner"):
                both_open.wait()
                torch.ones(64) @ torch.ones(64)
            with profiling.span("pmnet.m.own", batch=4):
                pass
        t.join(timeout=30)
    assert not t.is_alive()

    got = {s["name"]: s for s in profiling.spans()}
    assert set(got) == {"pmnet.w.outer", "pmnet.w.inner", "pmnet.m.outer", "pmnet.m.inner",
                        "pmnet.m.own"}
    ids = {s["id"]: s["name"] for s in got.values()}
    parent = {n: ids.get(s["parent"]) for n, s in got.items()}
    assert parent == {"pmnet.w.outer": None, "pmnet.w.inner": "pmnet.w.outer",
                      "pmnet.m.outer": None, "pmnet.m.inner": "pmnet.m.outer",
                      "pmnet.m.own": "pmnet.m.outer"}
    assert {n: s["thread"] for n, s in got.items()} == {
        "pmnet.w.outer": "pmnet-test-worker", "pmnet.w.inner": "pmnet-test-worker",
        "pmnet.m.outer": threading.current_thread().name,
        "pmnet.m.inner": threading.current_thread().name,
        "pmnet.m.own": threading.current_thread().name}
    assert {n: s["bi"] for n, s in got.items()} == {
        "pmnet.w.outer": 7, "pmnet.w.inner": 7, "pmnet.m.outer": 3, "pmnet.m.inner": 3,
        "pmnet.m.own": 4}
    for s in got.values():
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = got[parent[s["name"]]]
            assert p["start"] <= s["start"] <= s["end"] <= p["end"]

    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pmnet.")}
    for name in ("pmnet.m.outer", "pmnet.m.inner", "pmnet.m.own"):
        e, s = events[name], got[name]
        assert abs(e.start_ns() - s["start"]) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - s["end"]) < 1_000_000, name


def test_counts_add_up_across_threads():
    """8 threads x 500 counts and spans with a short switch interval: no
    lost update."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(500):
                profiling.count("pmnet.n", k)
                with profiling.span("pmnet.s", batch=k):
                    pass

        with _profiled():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(1, 9)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counts() == {"pmnet.n": 500 * sum(range(1, 9))}
    spans = profiling.spans()
    assert len(spans) == 8 * 500 and len({s["id"] for s in spans}) == len(spans)
    assert all(s["parent"] is None for s in spans)


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    with _profiled():
        with profiling.span("pmnet.before"):
            pass
    with profiling.trace(tmp_path / "t"):
        with profiling.span("pmnet.x", batch=2):
            torch.ones(8).sum()
        profiling.count("pmnet.n", 3)
    traces = list((tmp_path / "t").glob("*.pt.trace.json"))
    assert len(traces) == 1
    stem = traces[0].name[: -len(".pt.trace.json")]
    written = json.loads((tmp_path / "t" / f"{stem}.pmnet.json").read_text())
    assert [(s["name"], s["bi"]) for s in written["spans"]] == [("pmnet.x", 2)]
    assert written["counts"] == {"pmnet.n": 3}
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pmnet.x" for e in events)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A v3 store of 48 synthetic ligands x 3 conformers in 3 batches, with
    leaf caps low enough that some ligands go to the host DFS."""
    path = tmp_path_factory.mktemp("spans") / "tiles"
    pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=12, seed=5))
    ligands = synthetic.make_synthetic_ligands(3 * BATCH, num_conformers=3, seed=4)
    tts.write_v3_store(path, pm, ligands, [f"lig{i:02d}" for i in range(len(ligands))],
                       batch_size=BATCH, verbose=False, device="cpu", leaf_caps=(24, 64))
    return path, pm


def test_stored_screen_spans_and_counters(store, tmp_path):
    path, pm = store
    screener = tbs.BatchScreener(pm, device="cpu")
    plain = cli.screen_tiles(screener, str(path), str(tmp_path / "plain.csv"))
    assert profiling.spans() == [] and profiling.counts() == {}

    handed = {"all": 0, "read_only": 0}
    to_device = screener._to_device

    def counting(a, *args, **kw):
        a = np.asarray(a)
        handed["all"] += a.nbytes
        handed["read_only"] += 0 if a.flags.writeable else a.nbytes
        return to_device(a, *args, **kw)

    screener._to_device = counting
    with _profiled():
        traced = cli.screen_tiles(screener, str(path), str(tmp_path / "traced.csv"))
    assert traced == plain  # names and scores, bit for bit

    spans = profiling.spans()
    by_id = {s["id"]: s for s in spans}
    dispatch = [s for s in spans if s["name"] == "pmnet.dispatch"]
    assert sorted(s["bi"] for s in dispatch) == [0, 1, 2]
    for d in dispatch:
        children = [s for s in spans if s["parent"] == d["id"]]
        assert {s["name"] for s in children} == {"pmnet.dispatch.copy_out", "pmnet.dispatch.h2d"}
        assert all(s["bi"] == d["bi"] and s["thread"] == d["thread"] for s in children)
    for name in ("pmnet.store.load", "pmnet.store.page_in", "pmnet.tail", "pmnet.csv"):
        assert sorted(s["bi"] for s in spans if s["name"] == name) == [0, 1, 2], name
    assert {s["thread"] for s in spans if s["name"].startswith("pmnet.store.")
            and s["name"] != "pmnet.store.wait"} == {"tile-prefetch"}
    # one wait per batch, and one for the prefetch thread's end marker
    assert [s["bi"] for s in spans if s["name"] == "pmnet.store.wait"] == [0, 1, 2, None]
    for name in ("pmnet.tail.d2h", "pmnet.tail.dfs"):
        assert all(by_id[s["parent"]]["name"] == "pmnet.tail" for s in spans if s["name"] == name)

    counts = profiling.counts()
    outliers = sum(len(tts.TiledStore(path).load(b).leaf2_out["live"]) for b in range(3))
    assert outliers > 0
    assert counts == {"pmnet.copy_out_bytes": handed["read_only"],
                      "pmnet.h2d_bytes": handed["all"], "pmnet.dfs_ligands": outliers}
    assert 0 < handed["read_only"] <= handed["all"]
