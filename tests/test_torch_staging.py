"""Page-locked staging of read-only store arrays (`scoring/staging.py`)
and `BatchScreener._to_device` around it.

On the CPU: which arrays are staged; the host memcpy from a read-only
mapping (bit-equal, in one part or several, the mapping never written);
the ring's reuse rule under events that complete late (no region handed
out while a copy from it may run, page-locked memory allocated only when
a claim outgrows half the ring); a read-only mapping reaching the CPU
screener bit-equal; a v3 store screened through `screen_tiles` equal to
its batches scored from writeable copies. On a card (marked `gpu`, skip
without one; no JAX is imported here): three stored batches copied back
to back behind a busy stream equal plain copies, a source changed after
`_to_device` returns leaves the device tensor as it was, and the staged
byte counter covers a stored batch and no live one.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import itertools
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.cli import screening as cli
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import staging
from pharmaconet_tpu_torch.scoring import tiled_store as tts
from pharmaconet_tpu_torch.utils import profiling

BATCH = 16


def _mapping(path: Path, a: np.ndarray) -> np.memmap:
    """`a` written to `path` and mapped back read-only."""
    w = np.memmap(path, dtype=a.dtype, mode="w+", shape=a.shape)
    w[...] = a
    w.flush()
    del w
    return np.memmap(path, dtype=a.dtype, mode="r", shape=a.shape)


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _operands(sb) -> list[np.ndarray]:
    """Every array of a leaf-baked v3 batch that its dispatch copies."""
    arrays = [sb.dt, sb.gid, sb.tab, sb.aux, sb.leaf2_out_ends]
    for b in sb.leaf_buckets:
        arrays.extend(b)
    return arrays


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A v3 store of 48 synthetic ligands x 3 conformers in 3 batches of
    16, leaves baked in buckets."""
    path = tmp_path_factory.mktemp("staging") / "tiles"
    pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=12, seed=5))
    ligands = synthetic.make_synthetic_ligands(3 * BATCH, num_conformers=3, seed=4)
    tts.write_v3_store(path, pm, ligands, [f"lig{i:02d}" for i in range(len(ligands))],
                       batch_size=BATCH, verbose=False, device="cpu")
    return path, pm


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def test_stages_only_read_only_arrays_bound_for_a_card():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    ro = np.arange(12, dtype=np.int32)
    ro.flags.writeable = False
    rw = np.arange(12, dtype=np.int32)
    empty = np.zeros((4, 0), np.uint8)
    empty.flags.writeable = False
    assert staging.stages(ro, cuda)
    assert not staging.stages(rw, cuda)
    assert not staging.stages(ro, cpu) and not staging.stages(rw, cpu)
    assert not staging.stages(empty, cuda)  # nothing to copy


@pytest.mark.parametrize("parts", [1, 4])
def test_copy_into_reads_a_mapping_bit_equal(tmp_path, parts):
    """The memcpy into the ring: C-contiguous mappings from SPLIT bytes up
    in `parts` slices, a strided view in one; bytes equal, the mapping's
    file unchanged, the rest of the buffer untouched."""
    rng = np.random.default_rng(7)
    big = _mapping(tmp_path / "big.bin",
                   rng.standard_normal((staging.SPLIT // 4096 + 3, 1024)).astype(np.float32))
    small = _mapping(tmp_path / "small.bin", rng.integers(0, 1 << 30, (33, 5), dtype=np.int32))
    before = {p: _digest(p) for p in tmp_path.iterdir()}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for a in (big, small, small[:, ::2], big[5:9]):
            dst = np.full(a.nbytes + 4096, 0xAB, np.uint8)
            staging.copy_into(dst, a, pool, parts)
            got = dst[:a.nbytes].view(a.dtype).reshape(a.shape)
            assert np.array_equal(got, np.asarray(a))
            assert (dst[a.nbytes:] == 0xAB).all()
    assert {p: _digest(p) for p in tmp_path.iterdir()} == before


class _LateEvent:
    """An event that completes only when waited for, or when its copy is
    marked done: the card that lags as far behind as it may."""

    def __init__(self, log, region):
        self.log, self.region, self.done = log, region, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.done = True
        self.log.append(self.region)


def test_ring_never_hands_out_a_region_in_flight(monkeypatch):
    """Random claims over a ring whose copies complete only when waited
    for: no claim overlaps a region whose copy may still run, every claim
    lies inside the buffer and is aligned, and page-locked memory is
    allocated only when a claim outgrows half the ring; the same claims
    again allocate nothing."""
    monkeypatch.setattr(staging, "MIN_RING", 0)
    allocs = []
    ring = staging.StagingRing(lambda n: allocs.append(n) or torch.empty(n, dtype=torch.uint8))
    rng = np.random.default_rng(3)
    sizes = [int(s) for s in rng.integers(1, 40_000, 400)] + [120_000] + \
        [int(s) for s in rng.integers(1, 70_000, 400)]
    waited, in_flight = [], []
    for round_ in range(2):
        for k, n in enumerate(sizes):
            cap, count = ring.capacity, ring.allocations
            start = ring.claim(n)
            if ring.allocations > count:
                assert 2 * n > cap and ring.capacity >= 2 * n, (n, cap)
                in_flight = []  # the old buffer: every copy from it was waited for
            assert start % staging.ALIGN == 0 and start + n <= ring.capacity
            for ev in in_flight:
                s, e = ev.region
                assert ev.done or e <= start or start + n <= s, (round_, k, ev.region, start, n)
            ev = _LateEvent(waited, (start, start + n))
            ring.release(start, n, ev)
            in_flight = [e for e in in_flight if not e.done] + [ev]
            if k % 97 == 0:  # the card catches up now and then
                for e in in_flight:
                    e.done = True
        if round_ == 0:
            first = list(allocs)
    assert allocs == first and len(first) >= 2
    assert waited  # the ring wrapped onto copies in flight, and waited


def test_read_only_mapping_reaches_the_cpu_screener_bit_equal(store, tmp_path):
    path, pm = store
    screener = tbs.BatchScreener(pm, device="cpu")
    assert screener._staging is None
    files = sorted((path / "batches" / "00001").glob("*.npy"))
    before = {f: _digest(f) for f in files}
    sb = tts.TiledStore(path, pm).load(1)
    arrays = [a for a in _operands(sb) if isinstance(a, np.memmap)]
    assert arrays and not any(a.flags.writeable for a in arrays)
    with profile(activities=[ProfilerActivity.CPU]):
        got = [screener._to_device(a) for a in arrays]
    for a, t in zip(arrays, got):
        assert t.device.type == "cpu" and t.dtype == torch.from_numpy(np.array(a)).dtype
        assert np.array_equal(t.numpy(), np.asarray(a))
    nbytes = sum(a.nbytes for a in arrays)
    assert profiling.counts() == {"pmnet.copy_out_bytes": nbytes, "pmnet.h2d_bytes": nbytes}
    del sb, arrays
    assert {f: _digest(f) for f in files} == before


def test_screen_tiles_equals_writeable_batches(store, tmp_path):
    """The stored screen from read-only mappings gives the scores of the
    same batches loaded as writeable arrays, in library order."""
    path, pm = store
    screener = tbs.BatchScreener(pm, device="cpu")
    got = cli.screen_tiles(screener, str(path), str(tmp_path / "scores.csv"))
    reader = tts.TiledStore(path, pm)
    want = list(itertools.chain.from_iterable(
        screener.score_stored(reader.load(b, mmap=False)) for b in range(3)))
    assert [n for n, _ in got] == [f"lig{i:02d}" for i in range(3 * BATCH)]
    assert [s for _, s in got] == want


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_back_to_back_batches_equal_plain_copies(cuda, store, monkeypatch):
    """Three stored batches copied one after another behind a stream kept
    busy, through a ring small enough to wrap onto copies in flight: each
    tensor equals the plain copy of its array, so no region was written
    while the card still read it."""
    monkeypatch.setattr(staging, "MIN_RING", 0)
    path, pm = store
    screener = tbs.BatchScreener(pm, device=cuda)
    reader = tts.TiledStore(path, pm)
    batches = [reader.load(b) for b in range(3)]
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.cuda.stream(screener.stream):
            torch.cuda._sleep(200_000_000)  # about 0.1 s of a busy stream
            got = [[screener._to_device(a) for a in _operands(sb)] for sb in batches]
        torch.cuda.synchronize(cuda)
    for sb, tensors in zip(batches, got):
        for a, t in zip(_operands(sb), tensors):
            assert torch.equal(t.cpu(), torch.from_numpy(np.array(a)))
    assert profiling.counts().get("pmnet.h2d_stage_waits", 0) > 0  # the guard held
    ring = screener._staging.ring
    assert ring.allocations == 1
    largest = max(a.nbytes for sb in batches for a in _operands(sb))
    assert ring.capacity < sum(a.nbytes for sb in batches for a in _operands(sb))
    assert ring.capacity >= 2 * largest


@pytest.mark.gpu
def test_source_changed_after_the_call_leaves_the_tensor(cuda, tmp_path):
    """`_to_device` has read its source in full when it returns: a
    writeable array (the pageable copy) and a read-only mapping (staged)
    changed right after the call, behind a busy stream, leave the device
    tensor as it was."""
    screener = tbs.BatchScreener(tbs.PackedModel.from_model(
        synthetic.make_synthetic_model(num_clusters=4, seed=0)), device=cuda)
    want = np.arange(1 << 20, dtype=np.float32)
    writeable = want.copy()
    mapped = _mapping(tmp_path / "m.bin", want)
    assert staging.stages(mapped, cuda) and not staging.stages(writeable, cuda)
    with torch.cuda.stream(screener.stream):
        torch.cuda._sleep(200_000_000)
        t_rw = screener._to_device(writeable)
        writeable[:] = -1.0
        t_ro = screener._to_device(mapped)
        w = np.memmap(tmp_path / "m.bin", dtype=np.float32, mode="r+", shape=want.shape)
        w[:] = -1.0
        w.flush()
        del w
    torch.cuda.synchronize(cuda)
    assert np.array_equal(np.asarray(mapped), writeable)  # the file did change
    assert torch.equal(t_rw.cpu(), torch.from_numpy(want))
    assert torch.equal(t_ro.cpu(), torch.from_numpy(want))
    os.remove(tmp_path / "m.bin")


@pytest.mark.gpu
def test_staged_bytes_cover_a_stored_batch_and_no_live_one(cuda, store):
    """Under the profiler, `pmnet.h2d_staged_bytes` equals
    `pmnet.h2d_bytes` on a stored batch's dispatch (every array read-only)
    and stays 0 on a live batch (writeable pack buffers); scores equal the
    CPU screener's; a second pass allocates no page-locked memory."""
    path, pm = store
    screener = tbs.BatchScreener(pm, device=cuda)
    plain = tbs.BatchScreener(pm, device="cpu")
    reader = tts.TiledStore(path, pm)
    sb = reader.load(0)
    with profile(activities=[ProfilerActivity.CPU]):
        scores = screener.score_stored(sb)
    counts = profiling.counts()
    assert counts["pmnet.h2d_staged_bytes"] == counts["pmnet.h2d_bytes"] > 0
    np.testing.assert_allclose(scores, plain.score_stored(sb), rtol=2e-5, atol=1e-4)

    allocations = screener._staging.ring.allocations
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        screener.score_stored(reader.load(0))
    assert "pmnet.h2d_pinned_alloc_bytes" not in profiling.counts()
    assert screener._staging.ring.allocations == allocations

    profiling.clear()
    live = synthetic.make_synthetic_ligands(BATCH, num_conformers=3, seed=9)
    with profile(activities=[ProfilerActivity.CPU]):
        screener.score_packed(live)
    counts = profiling.counts()
    assert counts["pmnet.h2d_bytes"] > 0
    assert counts.get("pmnet.h2d_staged_bytes", 0) == 0
