"""The fused screening kernels (K1, K4, K5) of pharmaconet_tpu_torch.

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

from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
from pharmaconet_tpu_torch.scoring.batch_screen import (
    BatchScreener,
    PackedModel,
    build_batch,
    scan_fail,
)
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
    assert screen_cuda.LAUNCHES == {"score_tiles_fused_rows": 1, "score_blocks_fused": 1,
                                    "gaussian_phase": 1}


@pytest.mark.gpu
def test_cuda_screener_matches_cpu(cuda):
    pm = PackedModel.from_model(make_synthetic_model(num_clusters=20, seed=0))
    ligands = make_synthetic_ligands(96, seed=1)
    want = BatchScreener(pm, device="cpu", engine="reference").score_packed(ligands)
    for kw in ({}, dict(native_pack=False), dict(fused=False), dict(engine="reference")):
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
