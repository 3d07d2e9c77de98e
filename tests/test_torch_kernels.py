"""The screening kernels (K1-K5) and the voxelizer (K6) of
pharmaconet_tpu_torch.

This file imports no JAX. The CPU tests hold the plain torch versions
against each other (tile-local scans against the whole-row scans of the
split route) at several conformer counts. The tests marked `gpu` hold each
CUDA kernel against its plain version on the card; they skip without one.
On a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

from __future__ import annotations

import threading

import pytest
import torch

from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref, voxelize_cuda
from pharmaconet_tpu_torch.ops.voxelize import voxelize
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
                                    "gaussian_phase": 1}


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
def test_cuda_kernel_rejects_too_many_conformers(cuda):
    pos = torch.zeros(1, 27, 64, device=cuda)
    flat = [torch.zeros(8, 1024, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="conformers"):
        screen_cuda.gaussian_phase(pos, torch.zeros(1, 1024, dtype=torch.int32, device=cuda), *flat)


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
