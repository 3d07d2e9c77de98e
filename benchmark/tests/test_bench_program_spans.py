"""The readers of the program's own spans (program_spans.py and the metrics
that use it), on hand-made spans and device intervals: clipped to the
window, per batch dispatched, self time less the children, the card's
idle time inside the screening thread's spans; None for a program without
the recorder or a window with no dispatch."""

import harness
import pytest
from conftest import BENCH_DIR, ROOT

import program_spans
from pharmaconet_tpu_torch.utils import profiling

MS = 1_000_000
MAIN, PREFETCH = "MainThread", "tile-prefetch"


def _span(i, name, start, end, parent=None, thread=MAIN, bi=0):
    return dict(id=i, name=name, parent=parent, thread=thread, bi=bi,
                start=int(start * MS), end=int(end * MS))


SPANS = [
    _span(0, "pmnet.store.wait", -5, 2),  # began before the window
    _span(1, "pmnet.dispatch", 2, 40),
    _span(2, "pmnet.dispatch.copy_out", 5, 15, parent=1),
    _span(3, "pmnet.dispatch.h2d", 15, 35, parent=1),
    _span(4, "pmnet.store.wait", 40, 41, bi=1),
    _span(5, "pmnet.dispatch", 41, 80, bi=1),
    _span(6, "pmnet.dispatch.copy_out", 45, 50, parent=5, bi=1),
    _span(7, "pmnet.dispatch.h2d", 50, 72, parent=5, bi=1),
    _span(8, "pmnet.tail", 80, 90),
    _span(9, "pmnet.store.load", 0, 50, thread=PREFETCH, bi=1),
    _span(10, "pmnet.dispatch", 120, 130, bi=2),  # after the window
]
TIMELINE = {
    "device": [("k", 10 * MS, 20 * MS, False), ("Memcpy HtoD", 30 * MS, 40 * MS, True),
               ("k", 70 * MS, 75 * MS, False)],
    "spans": [("bench.window", 0, 100 * MS)],
}
WANT = {  # 2 batches in the window; the card idles in 0-10, 20-30, 40-70, 75-100
    "copy_out_ms": (10 + 5) / 2,
    "h2d_host_ms": (20 + 22) / 2,
    "launch_ms": ((38 - 30) + (39 - 27)) / 2,
    "prefetch_wait_ms": (2 + 1) / 2,
    "idle_copy_out": 5 + 5,  # 5-10 and 45-50 of 100 ms
    "idle_h2d": 10 + 20,  # 20-30 and 50-70
}


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in SPANS])


def _read(name, records):
    path = harness.metric_path(BENCH_DIR, name)
    return harness.load_module(path, f"metric_{path.stem}").read(records)


@pytest.mark.parametrize("name", sorted(WANT) + ["h2d_host_ms.card"])
def test_reader_on_hand_made_spans(recorded, name):
    got = _read(name, dict(timeline=TIMELINE))
    assert got == pytest.approx(WANT[name.split(".")[0]], rel=1e-12)


def test_idle_share_counts_the_screening_thread_alone(recorded):
    records = dict(timeline=TIMELINE)
    assert program_spans.idle_share(records, ("pmnet.store.load",)) == 0.0
    # every span of the screening thread: all idle time but 90-100
    got = program_spans.idle_share(records, ("pmnet.store.wait", "pmnet.dispatch", "pmnet.tail"))
    assert got == pytest.approx(10 + 10 + 30 + 15)


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_reads_none(monkeypatch, name):
    """A program without the recorder (the parent of the spans), a window
    without a dispatch, a run without a timeline: None, never a raise."""
    monkeypatch.delattr(profiling, "spans")
    assert _read(name, dict(timeline=TIMELINE)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [s for s in SPANS
                                                      if s["name"] != "pmnet.dispatch"],
                        raising=False)
    assert _read(name, dict(timeline=TIMELINE)) is None
    assert _read(name, dict(timeline=None)) is None


def test_new_metrics_are_entries_of_their_cells():
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    layer = {m["name"]: m for m in spec["per_layer"]}
    for name in WANT:
        assert layer[name]["workloads"] == ["pm20.stored-c16"], name
        assert layer[name]["moves"] == "screen_lig_per_s"
    assert layer["h2d_host_ms.card"]["workloads"] == ["pm20.stored-c8"]
    assert layer["h2d_host_ms.card"]["moves"] == "card_ms_per_klig"
