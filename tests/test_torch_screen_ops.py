"""The port's plain torch screening functions against the JAX package's.

Identical numpy-seeded inputs go through the JAX function (Pallas kernels
in interpret mode) and its torch counterpart in pharmaconet_tpu_torch;
scores agree within rtol 2e-5 / atol 1e-4 and the -1 (failed pair) masks
are equal. Sizes stay at <= 4 tiles of 1024 rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.ops import screen_pallas as jops
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring.tiled_pack import build_tiled_batch as j_build_tiled
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch as t_build_tiled

RTOL, ATOL = 2e-5, 1e-4
WIDTH = 4 * 1024  # pinned tiled width: 4 tiles


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def inputs():
    """Both packages' packed model and ligands from the same seeds."""
    j_model = bench.make_synthetic_model(num_clusters=8, seed=5)
    t_model = synthetic.make_synthetic_model(num_clusters=8, seed=5)
    return dict(
        j_pm=jbs.PackedModel.from_model(j_model),
        t_pm=tbs.PackedModel.from_model(t_model),
        j_lig=bench.make_synthetic_ligands(16, seed=6),
        t_lig=synthetic.make_synthetic_ligands(16, seed=6),
    )


@pytest.fixture(scope="module")
def tiled_batches(inputs):
    jt = j_build_tiled(inputs["j_pm"], inputs["j_lig"], width=WIDTH)
    tt = t_build_tiled(inputs["t_pm"], inputs["t_lig"], width=WIDTH)
    return jt, tt


@pytest.fixture(scope="module")
def row_layouts(inputs):
    """The untiled batch and the tiled row layout (K4/K5 inputs), both
    packages, pinned to WIDTH."""
    jscr = jbs.BatchScreener(inputs["j_pm"], engine="pallas", pallas_interpret=True)
    jb = jbs.build_batch(inputs["j_pm"], inputs["j_lig"])
    tscr = tbs.BatchScreener(inputs["t_pm"], device="cpu")
    tb = tbs.build_batch(inputs["t_pm"], inputs["t_lig"])
    return (jscr, jb, jscr.device_args_pallas(jb, ns_tiled=WIDTH),
            tscr, tb, tscr.device_args_tiled(tb, ns_tiled=WIDTH))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_k1_score_tiles_fused_rows_matches_jax(tiled_batches):
    jt, tt = tiled_batches
    assert tt.gtab.shape[0] == 4 and tt.nst > 3 * 1024  # all four tiles hold rows
    want = jops.score_tiles_fused_rows(
        jnp.asarray(jt.pos_blocks), jnp.asarray(jt.uv), jnp.asarray(jt.gtab),
        jnp.asarray(jt.aux), depth1=jt.depth1, depth2=jt.depth2, interpret=True,
    )
    args = [_t(a) for a in (tt.pos_blocks, tt.uv, tt.gtab, tt.aux)]
    got = screen_ref.score_tiles_fused_rows(*args, tt.depth1, tt.depth2)
    assert got.shape == (WIDTH, 4)
    assert_scores_close(got, want)
    assert (np.asarray(want) == -1.0).any() and (np.asarray(want) > 0).any()
    # [C, NST] form, and the wrapper takes the plain version for CPU tensors
    assert_scores_close(screen_ref.score_tiles_fused(*args, tt.depth1, tt.depth2).T, want)
    wrapped = screen_cuda.score_tiles_fused_rows(*args, tt.depth1, tt.depth2)
    assert torch.equal(wrapped, got)


def _k4_args(tiled, as_f32_rows=True):
    base = [_t(a) for a in (tiled.pos_blocks, tiled.uv_packed, tiled.muT,
                             tiled.invT, tiled.winvT)]
    rows = [_t(a) for a in (tiled.flags_block, tiled.flags_pair, tiled.end_mn_inv,
                            tiled.end_mn_half, tiled.end_fail_gate, tiled.thr_ns,
                            tiled.self_ns)]
    if as_f32_rows:
        rows = [r.float() for r in rows]
    return base, rows


def test_tiled_row_layouts_equal(row_layouts):
    _, _, jtile, _, _, ttile = row_layouts
    for f in ("pos_blocks", "uv_packed", "muT", "invT", "winvT", "flags_block",
              "flags_pair", "end_mn_inv", "end_mn_half", "end_fail_gate", "thr_ns",
              "self_ns", "pair_end_rows"):
        np.testing.assert_array_equal(getattr(ttile, f), getattr(jtile, f), err_msg=f)
    assert (ttile.depth1, ttile.depth2) == (jtile.depth1, jtile.depth2)


def test_k4_score_blocks_fused_matches_jax(row_layouts):
    _, _, jtile, _, _, ttile = row_layouts
    want = jops.score_blocks_pallas_fused(
        *(jnp.asarray(getattr(jtile, f)) for f in (
            "pos_blocks", "uv_packed", "muT", "invT", "winvT", "flags_block",
            "flags_pair", "end_mn_inv", "end_mn_half", "end_fail_gate", "thr_ns",
            "self_ns")),
        depth1=jtile.depth1, depth2=jtile.depth2, interpret=True,
    )
    base, rows = _k4_args(ttile)
    got = screen_ref.score_blocks_fused(*base, *rows, ttile.depth1, ttile.depth2)
    assert_scores_close(got, want)
    assert torch.equal(
        screen_cuda.score_blocks_fused(*base, *rows, ttile.depth1, ttile.depth2), got
    )


def test_k5_gaussian_phase_matches_jax(row_layouts):
    _, _, jtile, _, _, ttile = row_layouts
    want = jops.gaussian_phase_pallas(
        *(jnp.asarray(getattr(jtile, f)) for f in ("pos_blocks", "uv_packed", "muT",
                                                    "invT", "winvT")),
        interpret=True,
    )
    base, _ = _k4_args(ttile)
    got = screen_ref.gaussian_phase(*base)
    c = got.shape[0] // 2
    np.testing.assert_array_equal(got[c:].numpy(), np.asarray(want)[c:])  # pass counts exact
    assert_scores_close(got, want)
    assert torch.equal(screen_cuda.gaussian_phase(*base), got)


def test_split_route_matches_jax_score_blocks_pallas(row_layouts):
    """K5 + the torch scans (the fused=False route) against the JAX
    score_blocks_pallas (Gaussian kernel + XLA scans)."""
    _, _, jtile, _, _, ttile = row_layouts
    fields = ("pos_blocks", "uv_packed", "muT", "invT", "winvT", "flags_block",
              "flags_pair", "end_mn_inv", "end_mn_half", "end_fail_gate", "thr_ns",
              "self_ns")
    want = jops.score_blocks_pallas(
        *(jnp.asarray(getattr(jtile, f)) for f in fields),
        depth1=jtile.depth1, depth2=jtile.depth2, interpret=True,
    )
    t = {f: _t(getattr(ttile, f)) for f in fields}
    sp = screen_ref.gaussian_phase(*(t[f] for f in fields[:5]))
    c = sp.shape[0] // 2
    got = tbs.scan_fail(sp[:c], sp[c:], *(t[f] for f in fields[5:]),
                        ttile.depth1, ttile.depth2)
    assert_scores_close(got, want)


def test_score_blocks_device_matches_jax(row_layouts):
    jscr, jb, _, tscr, tb, _ = row_layouts
    jargs, (jd1, jd2) = jscr.device_args(jb)
    targs, (td1, td2) = tscr.device_args(tb)
    assert (jd1, jd2) == (td1, td2)
    want = jbs.score_blocks_device(*jargs, depth1=jd1, depth2=jd2)
    got = tbs.score_blocks_device(*(_t(a) for a in targs), depth1=td1, depth2=td2)
    assert_scores_close(got, want)


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_bounded_segmented_scan_matches_jax(depth):
    rng = np.random.default_rng(depth)
    x = rng.normal(size=(6, 3000)).astype(np.float32)
    flags = rng.random(3000) < 0.3
    flags[0] = True
    want = jbs._bounded_segmented_scan(jnp.asarray(x), jnp.asarray(flags), depth)
    got = tbs._bounded_segmented_scan(_t(x), _t(flags), depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth", [1, 3, 10])
def test_tile_scan_matches_segmented_scan(depth):
    """The tile-local scan equals the JAX whole-row scan when every tile
    starts a segment (the pair-aligned layout guarantees it)."""
    rng = np.random.default_rng(7 + depth)
    t, r, tile = 3, 4, 1024
    x = rng.normal(size=(r, t * tile)).astype(np.float32)
    flags = rng.random(t * tile) < 0.2
    flags[::tile] = True
    want = jbs._bounded_segmented_scan(jnp.asarray(x), jnp.asarray(flags), depth)
    got = screen_ref.scan_bounded_tile(
        _t(x).reshape(r, t, tile).permute(1, 0, 2),
        _t(flags).float().reshape(t, tile), depth,
    ).permute(1, 0, 2).reshape(r, t * tile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
