"""The screening kernels (K1-K5), the voxelizer (K6) and the probe kernels
(P1-P4) of pharmaconet_tpu_torch.

This file imports no JAX. The CPU tests hold the plain torch versions
against each other (tile-local scans against the whole-row scans of the
split route) at several conformer counts. The tests marked `gpu` hold each
CUDA kernel against its plain version on the card; they skip without one.
On a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref, voxelize_cuda
from pharmaconet_tpu_torch.ops.voxelize import voxelize
from pharmaconet_tpu_torch.probes import prep as probe_prep
from pharmaconet_tpu_torch.scoring.batch_screen import (
    BatchScreener,
    PackedModel,
    build_batch,
    scan_fail,
)
from pharmaconet_tpu_torch.scoring.screen_tiles import tile_distances
from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch
from pharmaconet_tpu_torch.synthetic import make_synthetic_ligands, make_synthetic_model

RTOL, ATOL = 2e-5, 1e-4
CONFORMERS = [1, 3, 8]


def assert_scores_close(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got == -1.0, want == -1.0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _layouts(c: int, n: int = 24):
    """K1 tile-major inputs and the K4/K5 row layout of one synthetic batch
    with `c` conformers per ligand (numpy)."""
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=10, seed=c))
    ligands = make_synthetic_ligands(n, num_conformers=c, seed=10 + c)
    tb = build_tiled_batch(pm, ligands)
    tiled = BatchScreener(pm, device="cpu").device_args_tiled(build_batch(pm, ligands))
    return tb, tiled


def _stored_args(c: int, device, n: int = 24):
    """K3's inputs (the one-pass pack's used tiles and their stored
    distances) and K2's (the screener's v3 layout) for one batch."""
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=10, seed=c))
    ligands = make_synthetic_ligands(n, num_conformers=c, seed=10 + c)
    tb = build_tiled_batch(pm, ligands)
    t = max(1, -(-tb.nst // 1024))
    dt = tile_distances(tb.pos_blocks[:t], tb.uv[:t])
    k3 = [torch.from_numpy(a).to(device) for a in (dt, tb.gtab[:t], tb.aux[:t])]
    vb = BatchScreener(pm, engine="v3", device="cpu").build_vb(build_batch(pm, ligands))
    k2 = [torch.from_numpy(a).to(device) for a in (vb.dt, vb.gid, vb.tab, vb.aux)]
    ends = torch.from_numpy(vb.ends_padded).to(device)
    return (k3, (tb.depth1, tb.depth2)), (k2, ends, dict(depth=vb.depth, mn_cap=vb.mn_cap))


def _k1_args(tb, device):
    t = max(1, -(-tb.nst // 1024))
    return [torch.from_numpy(a[:t]).to(device) for a in (tb.pos_blocks, tb.uv, tb.gtab, tb.aux)]


def _row_args(tiled, device):
    base = [torch.from_numpy(getattr(tiled, f)).to(device)
            for f in ("pos_blocks", "uv_packed", "muT", "invT", "winvT")]
    rows = [torch.from_numpy(getattr(tiled, f)).to(device)
            for f in ("flags_block", "flags_pair", "end_mn_inv", "end_mn_half",
                      "end_fail_gate", "thr_ns", "self_ns")]
    return base, rows


@pytest.mark.parametrize("c", CONFORMERS)
def test_plain_fused_equals_split_route(c):
    """The tile-local scans of plain K1/K4 equal the whole-row torch scans
    of the split route on the same Gaussian phase: the pair-aligned layout
    keeps every segment in a tile."""
    _, tiled = _layouts(c)
    base, rows = _row_args(tiled, "cpu")
    sp = screen_ref.gaussian_phase(*base)
    t = base[0].shape[0]
    tiles = screen_ref._tiles(sp)  # [T, 2C, TILE]
    fused = screen_ref._untile(screen_ref.scan_fail_tail(
        tiles[:, :c], tiles[:, c:], *(r.float().reshape(t, 1024) for r in rows),
        tiled.depth1, tiled.depth2))
    split = scan_fail(sp[:c], sp[c:], *rows, tiled.depth1, tiled.depth2)
    assert_scores_close(fused, split)
    assert (fused == -1.0).any() and (fused > 0).any()


@pytest.mark.parametrize("c", CONFORMERS)
def test_plain_k1_equals_k4_on_the_same_batch(c):
    """K1 over the one-pass pack and K4 over the reference layout give the
    same pair table (same rows, two input layouts)."""
    tb, tiled = _layouts(c)
    k1 = screen_ref.score_tiles_fused_rows(*_k1_args(tb, "cpu"), tb.depth1, tb.depth2)
    base, rows = _row_args(tiled, "cpu")
    k4 = screen_ref.score_blocks_fused(*base, *(r.float() for r in rows),
                                       tiled.depth1, tiled.depth2)
    ends = torch.from_numpy(tb.pair_end_rows)
    assert torch.equal(ends, torch.from_numpy(tiled.pair_end_rows))
    live = ends >= 0
    assert_scores_close(k1[ends[live]], k4.T[ends[live]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("c", CONFORMERS)
def test_cuda_kernels_match_plain(cuda, c):
    tb, tiled = _layouts(c)
    screen_cuda.reset_launch_counts()
    args = _k1_args(tb, cuda)
    assert_scores_close(
        screen_cuda.score_tiles_fused_rows(*args, tb.depth1, tb.depth2),
        screen_ref.score_tiles_fused_rows(*args, tb.depth1, tb.depth2),
    )
    base, rows = _row_args(tiled, cuda)
    rows = [r.float() for r in rows]
    d = (tiled.depth1, tiled.depth2)
    assert_scores_close(screen_cuda.score_blocks_fused(*base, *rows, *d),
                        screen_ref.score_blocks_fused(*base, *rows, *d))
    got, want = screen_cuda.gaussian_phase(*base), screen_ref.gaussian_phase(*base)
    assert torch.equal(got[c:], want[c:])  # pass counts are exact
    assert_scores_close(got, want)
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES == {"score_tiles_fused_rows": 1, "score_tiles_v3": 0,
                                    "score_tiles_fused_dt": 0, "score_blocks_fused": 1,
                                    "gaussian_phase": 1, "gaussian_phase_gather": 0,
                                    "gaussian_phase_local": 0, "score_tiles_fused_ablation": 0,
                                    "score_tiles_fused_variant": 0, "score_tiles_v3_baseline": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("c", CONFORMERS)
def test_cuda_stored_kernels_match_plain(cuda, c):
    """K3 and K2 (rows, and pairs compacted on the device) against their
    plain versions on the card."""
    (k3, d), (k2, ends, kw) = _stored_args(c, cuda)
    screen_cuda.reset_launch_counts()
    assert_scores_close(screen_cuda.score_tiles_fused_dt_rows(*k3, *d),
                        screen_ref.score_tiles_fused_dt_rows(*k3, *d))
    want = screen_ref.score_tiles_v3_rows(*k2, **kw)
    assert_scores_close(screen_cuda.score_tiles_v3_rows(*k2, **kw), want)
    assert_scores_close(screen_cuda.score_tiles_v3_pairs(*k2, ends, **kw),
                        want.index_select(0, ends.long()))
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES["score_tiles_fused_dt"] == 1
    assert screen_cuda.LAUNCHES["score_tiles_v3"] == 2


@pytest.mark.gpu
def test_cuda_k2_refuses_a_table_beyond_shared_memory(cuda):
    (_, _), (k2, _, kw) = _stored_args(2, cuda)
    dt, gid, tab, aux = k2
    big = torch.zeros(tab.shape[0], 512, tab.shape[2], device=cuda)
    screen_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        screen_cuda.score_tiles_v3_rows(dt, gid, big, aux, **kw)
    assert screen_cuda.LAUNCHES["score_tiles_v3"] == 0


@pytest.mark.gpu
def test_cuda_stored_route_matches_cpu(cuda, tmp_path):
    """v3 (sparse leaf buckets, baked on the card) and v2 stores screen on
    the card as on the CPU."""
    from pharmaconet_tpu_torch.scoring.tiled_store import (
        TiledStore,
        write_tiled_store,
        write_v3_store,
    )

    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    ligands = make_synthetic_ligands(96, seed=1)
    names = [f"l{i}" for i in range(len(ligands))]
    write_v3_store(tmp_path / "v3", pm, ligands, names, batch_size=32, verbose=False,
                   device=cuda)
    write_tiled_store(tmp_path / "v2", pm, ligands, names, batch_size=32, verbose=False)
    want = BatchScreener(pm, device="cpu", engine="reference").score_packed(ligands)
    for kind in ("v3", "v2"):
        store = TiledStore(tmp_path / kind, pm)
        for device in ("cpu", cuda):
            screener = BatchScreener(pm, device=device)
            got = [s for bi in range(store.n_batches)
                   for s in screener.score_stored(store.load(bi))]
            torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_screener_matches_cpu(cuda):
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    ligands = make_synthetic_ligands(96, seed=1)
    want = BatchScreener(pm, device="cpu", engine="reference").score_packed(ligands)
    for kw in ({}, dict(native_pack=False), dict(fused=False), dict(engine="v3"),
               dict(engine="reference")):
        got = BatchScreener(pm, device=cuda, **kw).score_packed(ligands)
        torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("c", range(9, 17))
def test_cuda_kernels_take_more_than_8_conformers(cuda, c):
    """K1-K5 at C = 9..16 (one launch per group of at most 8 conformer
    columns, outputs joined) against their plain versions over all C."""
    tb, tiled = _layouts(c)
    groups = len(screen_cuda.conformer_groups(c))
    screen_cuda.reset_launch_counts()
    args, d = _k1_args(tb, cuda), (tb.depth1, tb.depth2)
    assert_scores_close(screen_cuda.score_tiles_fused_rows(*args, *d),
                        screen_ref.score_tiles_fused_rows(*args, *d))
    base, rows = _row_args(tiled, cuda)
    rows = [r.float() for r in rows]
    d = (tiled.depth1, tiled.depth2)
    assert_scores_close(screen_cuda.score_blocks_fused(*base, *rows, *d),
                        screen_ref.score_blocks_fused(*base, *rows, *d))
    got, want = screen_cuda.gaussian_phase(*base), screen_ref.gaussian_phase(*base)
    assert got.shape == (2 * c, base[1].shape[1]) and torch.equal(got[c:], want[c:])
    assert_scores_close(got, want)
    (k3, d), (k2, ends, kw) = _stored_args(c, cuda)
    assert_scores_close(screen_cuda.score_tiles_fused_dt_rows(*k3, *d),
                        screen_ref.score_tiles_fused_dt_rows(*k3, *d))
    want = screen_ref.score_tiles_v3_rows(*k2, **kw)
    assert_scores_close(screen_cuda.score_tiles_v3_rows(*k2, **kw), want)
    assert_scores_close(screen_cuda.score_tiles_v3_pairs(*k2, ends, **kw),
                        want.index_select(0, ends.long()))
    torch.cuda.synchronize()
    for name in ("score_tiles_fused_rows", "score_blocks_fused", "gaussian_phase",
                 "score_tiles_fused_dt"):
        assert screen_cuda.LAUNCHES[name] == groups, name
    assert screen_cuda.LAUNCHES["score_tiles_v3"] == 2 * groups


@pytest.mark.gpu
def test_cuda_k2_bit_equal_to_its_first_design_beyond_8_conformers(cuda):
    """Grouped K2 and its grouped first design, bit for bit, at C = 12."""
    (_, _), (k2, _, kw) = _stored_args(12, cuda)
    assert torch.equal(screen_cuda.score_tiles_v3_rows(*k2, **kw),
                       screen_cuda.score_tiles_v3_baseline_rows(*k2, **kw))


@pytest.mark.gpu
def test_cuda_probe_kernels_keep_the_conformer_cap(cuda):
    """The probe kernels P1-P4 run at their probes' fixed C: above the cap
    they raise, as before."""
    pos = torch.zeros(1, 27, 64, device=cuda)
    flat = [torch.zeros(8, 1024, device=cuda) for _ in range(3)]
    uv = torch.zeros(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="conformers"):
        screen_cuda.gaussian_phase_local(pos, uv, uv, *flat)


@pytest.mark.gpu
def test_cuda_screener_keeps_its_stream_across_threads(cuda):
    """A screener made under a side stream launches and copies back on that
    stream, also when another thread drives it."""
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    ligands = make_synthetic_ligands(64, seed=2)
    want = BatchScreener(pm, device="cpu").score_packed(ligands)
    side = torch.cuda.Stream(device=cuda)
    with torch.cuda.stream(side):
        screener = BatchScreener(pm, device=cuda)
    assert screener.stream == side
    got = []
    worker = threading.Thread(target=lambda: got.append(screener.score_packed(ligands)))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and len(got) == 1
    torch.testing.assert_close(torch.tensor(got[0]), torch.tensor(want), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# K1 and K2 against their first designs, bit for bit (K1's is P3's `full`)
# --------------------------------------------------------------------------
ALL_CONFORMERS = list(range(1, 9))


def _segment_flags(rng, tiles: int, longest: int) -> np.ndarray:
    """[tiles, TILE] f32 segment starts: one at every tile start, segments
    of 1..longest rows."""
    flags = np.zeros((tiles, 1024), dtype=np.float32)
    for t in range(tiles):
        pos = 0
        while pos < 1024:
            flags[t, pos] = 1.0
            pos += int(rng.integers(1, longest + 1))
    return flags


def _random_k1(c: int, tiles: int, depth1: int, depth2: int, seed: int, device):
    """K1's inputs at random: node tables, uv slots, Gaussian tables with a
    quarter of the weights 0, and block and pair segments as long as the
    depths reach (depth2 > 5: pairs longer than a warp)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=4.0, size=(tiles, 3 * c, 64)).astype(np.float32)
    uv = rng.integers(0, 64 * 64, size=(tiles, 1024), dtype=np.int32)
    mu = rng.uniform(1.0, 8.0, size=(tiles, 8, 1024))
    inv = rng.uniform(0.2, 2.0, size=(tiles, 8, 1024))
    winv = rng.uniform(0.0, 1.0, size=(tiles, 8, 1024)) * (rng.random((tiles, 8, 1024)) > 0.25)
    gtab = np.stack([mu, inv, winv], axis=1).astype(np.float32)
    aux = np.stack([
        _segment_flags(rng, tiles, 1 << depth1), _segment_flags(rng, tiles, 1 << depth2),
        rng.uniform(0.1, 1.0, size=(tiles, 1024)), rng.integers(0, 5, size=(tiles, 1024)),
        (rng.random((tiles, 1024)) > 0.5), rng.integers(0, 3, size=(tiles, 1024)),
        (rng.random((tiles, 1024)) > 0.8),
    ], axis=1).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (pos, uv, gtab, aux)]


def _random_k2(c: int, tiles: int, g_cap: int, mn_cap: int, depth: int, seed: int, device,
               outside: bool = False):
    """K2's inputs at random: per group mn valid entries with w = 0 above
    mn (and some zero weights below it), gid slots (with `outside`, some
    outside the table), pair segments as long as the depth reaches."""
    rng = np.random.default_rng(seed)
    r_pad = -(-(3 * mn_cap + 1) // 128) * 128
    tab = np.zeros((tiles, g_cap, r_pad), dtype=np.float32)
    mn = rng.integers(0, mn_cap + 1, size=(tiles, g_cap))
    k = np.arange(mn_cap)
    tab[:, :, :mn_cap] = rng.uniform(1.0, 8.0, size=(tiles, g_cap, mn_cap))
    tab[:, :, mn_cap : 2 * mn_cap] = rng.uniform(0.2, 2.0, size=(tiles, g_cap, mn_cap))
    w = rng.uniform(0.0, 1.0, size=(tiles, g_cap, mn_cap)) * (rng.random((tiles, g_cap, mn_cap)) > 0.2)
    tab[:, :, 2 * mn_cap : 3 * mn_cap] = np.where(k < mn[..., None], w, 0.0)
    tab[:, :, 3 * mn_cap] = (mn + 1) // 2
    dt = rng.uniform(0.5, 9.0, size=(tiles, c, 1024)).astype(np.float32)
    gid = rng.integers(-outside, g_cap + outside, size=(tiles, 1024), dtype=np.int32)
    aux = np.stack([_segment_flags(rng, tiles, 1 << depth),
                    rng.integers(0, 3, size=(tiles, 1024)),
                    rng.random((tiles, 1024)) > 0.7], axis=1).astype(np.float32)
    kw = dict(depth=depth, mn_cap=mn_cap)
    return [torch.from_numpy(a).to(device) for a in (dt, gid, tab, aux)], kw


def _k1_pair(args, d):
    """(K1, its first design) on the same inputs."""
    return (screen_cuda.score_tiles_fused_rows(*args, *d),
            screen_cuda.score_tiles_fused_ablation(*args, *d, "full"))


@pytest.mark.gpu
@pytest.mark.parametrize("c", ALL_CONFORMERS)
def test_cuda_k1_bit_equal_to_its_first_design(cuda, c):
    """On a packed batch (windowed scans) and on random layouts whose
    segments outrun a warp (depth 6 and 7: the block-wide branch) or need
    no scan step (depth 0), with more tiles than the card holds blocks."""
    tb, _ = _layouts(c)
    cases = [(_k1_args(tb, cuda), (tb.depth1, tb.depth2))]
    cases += [(_random_k1(c, tiles, d1, d2, 10 * c + d2, cuda), (d1, d2))
              for tiles, d1, d2 in ((3, 1, 3), (2, 6, 7), (300, 2, 5), (1, 0, 0))]
    for args, d in cases:
        got, want = _k1_pair(args, d)
        assert torch.equal(got, want), d
        assert_scores_close(got, screen_ref.score_tiles_fused_rows(*args, *d))


@pytest.mark.gpu
def test_cuda_k1_bit_equal_on_the_headline_batch(cuda):
    """The headline batch (2048 ligands x 4 conformers, 20-cluster model)."""
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    tb = build_tiled_batch(pm, make_synthetic_ligands(2048, num_conformers=4, seed=1), threads=8)
    args = _k1_args(tb, cuda)
    got, want = _k1_pair(args, (tb.depth1, tb.depth2))
    assert args[0].shape[0] > 1000 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("c", ALL_CONFORMERS)
def test_cuda_k2_bit_equal_to_its_first_design(cuda, c):
    """On the screener's v3 layout and on random tables: windowed and
    block-wide scans, no scan, gid slots outside the table, and a table too
    large for the double buffers (single ones)."""
    (_, _), (k2, _, kw) = _stored_args(c, cuda)
    cases = [(k2, kw)]
    cases += [_random_k2(c, tiles, g_cap, mn_cap, depth, 7 * c + depth, cuda, outside)
              for tiles, g_cap, mn_cap, depth, outside in
              ((3, 16, 16, 3, False), (2, 16, 24, 6, False), (300, 16, 8, 4, False),
               (2, 16, 16, 0, False), (3, 256, 16, 2, False), (3, 16, 16, 3, True))]
    for args, kw in cases:
        g_cap, r_pad = args[2].shape[1:]
        double = screen_cuda._v3_layout_bytes(c, g_cap, r_pad, 2) <= screen_cuda.MAX_SMEM
        assert double or screen_cuda.v3_shared_bytes(c, g_cap, r_pad) == \
            screen_cuda._v3_layout_bytes(c, g_cap, r_pad, 1)
        got = screen_cuda.score_tiles_v3_rows(*args, **kw)
        assert torch.equal(got, screen_cuda.score_tiles_v3_baseline_rows(*args, **kw)), kw
        if bool(((args[1] >= 0) & (args[1] < g_cap)).all()):  # the plain gather's range
            assert_scores_close(got, screen_ref.score_tiles_v3_rows(*args, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["dense", "sparse"])
def test_cuda_k2_on_v3_stores_of_both_leaf_wires(cuda, tmp_path, wire):
    """Every batch of a v3 store of either leaf wire: K2 bit-equal to its
    first design, and the store screened on the card as on the CPU."""
    from pharmaconet_tpu_torch.scoring.tiled_store import TiledStore, write_v3_store

    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    ligands = make_synthetic_ligands(96, seed=1)
    names = [f"l{i}" for i in range(len(ligands))]
    write_v3_store(tmp_path / wire, pm, ligands, names, batch_size=32, verbose=False,
                   leaf_wire=wire, device=cuda)
    store = TiledStore(tmp_path / wire, pm)
    for bi in range(store.n_batches):
        sb = store.load(bi)
        args = [torch.from_numpy(np.array(a)).to(cuda) for a in (sb.dt, sb.gid, sb.tab, sb.aux)]
        kw = dict(depth=sb.depth, mn_cap=sb.mn_cap)
        assert torch.equal(screen_cuda.score_tiles_v3_rows(*args, **kw),
                           screen_cuda.score_tiles_v3_baseline_rows(*args, **kw))
    want = [s for bi in range(store.n_batches)
            for s in BatchScreener(pm, device="cpu").score_stored(store.load(bi))]
    got = [s for bi in range(store.n_batches)
           for s in BatchScreener(pm, device=cuda).score_stored(store.load(bi))]
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_cuda_zero_tiles_launch_nothing(cuda):
    """K1 and K2 on zero tiles return empty rows and launch nothing."""
    k1 = [a[:0] for a in _random_k1(4, 1, 1, 3, 0, cuda)]
    k2, kw = _random_k2(4, 1, 16, 16, 3, 0, cuda)
    screen_cuda.reset_launch_counts()
    assert screen_cuda.score_tiles_fused_rows(*k1, 1, 3).shape == (0, 4)
    assert screen_cuda.score_tiles_v3_rows(*[a[:0] for a in k2], **kw).shape == (0, 4)
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES["score_tiles_fused_rows"] == 0
    assert screen_cuda.LAUNCHES["score_tiles_v3"] == 0


@pytest.mark.gpu
def test_cuda_k1_k2_resources(cuda):
    """Registers, shared memory and blocks per SM of K1, K2 and their first
    designs: every design fits a block of 1024 threads per SM at every C."""
    for name in screen_cuda.RESOURCE_IDS:
        for c in ALL_CONFORMERS:
            res = screen_cuda.kernel_resources(name, c)
            assert res["blocks_per_sm"] >= 1 and 0 < res["registers"] <= 64, (name, c, res)
            assert res["shared_bytes"] <= screen_cuda.MAX_SMEM, (name, c, res)
    big = screen_cuda.kernel_resources("score_tiles_v3", 8, g_cap=256, r_pad=128)
    assert big["shared_bytes"] == screen_cuda.v3_shared_bytes(8, 256, 128)


def _pocket_atoms(tmp_path, device, keep: int | None = None):
    """The padded atom arrays of a synthetic pocket as parsed for
    modeling (the 4096 bucket); `keep` marks only the first atoms valid
    and cuts the arrays to a ragged length."""
    from types import SimpleNamespace

    from pharmaconet_tpu_torch.module import PharmacoNet
    from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket

    info = write_synthetic_pocket(tmp_path / "pocket.pdb", seed=2)
    net = SimpleNamespace(grid_dim=64, get_center=PharmacoNet.get_center)
    data = PharmacoNet.parse(net, tmp_path / "pocket.pdb", center=info["center"])
    arrays = [data.atom_positions, data.atom_features, data.atom_valid]
    if keep is not None:
        arrays = [a[: keep + 37].copy() for a in arrays]
        arrays[2][keep:] = False
    return [torch.from_numpy(a).to(device) for a in (*arrays, data.center)]


@pytest.mark.gpu
@pytest.mark.parametrize("dim,keep", [(64, None), (64, 1001), (40, 333)],
                         ids=["pocket", "ragged-atoms", "ragged-grid"])
def test_cuda_voxelizer_matches_plain(cuda, tmp_path, dim, keep):
    """K6 on the card: occupancy bit-equal to the plain version, the image
    within atol/rtol 1e-5 (atoms summed in another order)."""
    args = _pocket_atoms(tmp_path, cuda, keep)
    voxelize_cuda.reset_launch_counts()
    img, occ = voxelize_cuda.voxelize_pallas(*args, dim=dim)
    torch.cuda.synchronize()
    assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == 1
    want_img, want_occ = voxelize(*args, dim=dim)
    assert img.shape == (dim, dim, dim, 33) and occ.dtype == torch.bool
    assert torch.equal(occ, want_occ) and occ.any()
    torch.testing.assert_close(img, want_img, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# probe kernels P1-P4 (their plain versions are held against the probe
# scripts' Pallas bodies in tests/test_torch_probes.py)
# --------------------------------------------------------------------------
def _probe_rows(c: int):
    rb = probe_prep.row_batch(*probe_prep.headline_inputs(24, num_conformers=c))
    return rb, probe_prep.gather_inputs(rb), probe_prep.local_tables(rb)


@pytest.mark.gpu
@pytest.mark.parametrize("c", CONFORMERS)
def test_cuda_p1_p2_match_plain(cuda, c):
    rb, gi, lt = _probe_rows(c)
    tables = [torch.from_numpy(a).to(cuda) for a in (rb.muT, rb.invT, rb.winvT)]
    uv = torch.from_numpy(lt.uv_loc).to(cuda)
    screen_cuda.reset_launch_counts()
    p1_in = [torch.from_numpy(gi.d_table).to(cuda), torch.from_numpy(gi.slots).to(cuda), *tables]
    p2_in = [torch.from_numpy(lt.pos_blocks).to(cuda), uv[0], uv[1], *tables]
    for got, want in ((screen_cuda.gaussian_phase_gather(*p1_in),
                       screen_ref.gaussian_phase_gather(*p1_in)),
                      (screen_cuda.gaussian_phase_local(*p2_in),
                       screen_ref.gaussian_phase_local(*p2_in))):
        assert torch.equal(got[c:], want[c:])  # pass counts are exact
        assert_scores_close(got, want)
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES["gaussian_phase_gather"] == 1
    assert screen_cuda.LAUNCHES["gaussian_phase_local"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("c", CONFORMERS)
def test_cuda_p3_p4_match_plain_and_k1(cuda, c):
    """Every ablation against its plain version, `full` bit-equal to K1,
    every variant against K1, and ohbf16's distances bit-equal to the
    prepack-time distances (numpy, correctly rounded)."""
    ti = probe_prep.tiled_inputs(*probe_prep.headline_inputs(24, num_conformers=c))
    x = [torch.from_numpy(a).to(cuda) for a in ti.arrays]
    d = (ti.depth1, ti.depth2)
    screen_cuda.reset_launch_counts()
    k1 = screen_cuda.score_tiles_fused_rows(*x, *d)
    for mode in screen_ref.ABLATIONS:
        got = screen_cuda.score_tiles_fused_ablation(*x, *d, mode)
        assert_scores_close(got, screen_ref.score_tiles_fused_ablation(*x, *d, mode))
        if mode == "full":
            assert torch.equal(got, k1)  # K1's own instantiation
    for mode in screen_ref.VARIANTS:
        assert_scores_close(screen_cuda.score_tiles_fused_variant(*x, *d, mode), k1)
    _, dist = screen_cuda.score_tiles_fused_variant(*x, *d, "ohbf16", return_distances=True)
    assert torch.equal(dist.cpu(), torch.from_numpy(tile_distances(ti.pos_blocks, ti.uv,
                                                                   native=False)))
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES["score_tiles_fused_ablation"] == 5
    assert screen_cuda.LAUNCHES["score_tiles_fused_variant"] == 4
    assert screen_cuda.MODE_LAUNCHES["score_tiles_fused_variant[ohbf16]"] == 2
