"""The stored route's layouts and kernels (K2, K3) against the JAX package.

Identical numpy-seeded inputs go through the JAX function (Pallas kernels
in interpret mode) and the port's plain torch version (what the K2/K3
wrappers run for CPU tensors): scores agree within rtol 2e-5 / atol 1e-4
and the -1 (failed pair) masks are equal. The host layouts (v3 blocks and
group tables, prepack-time distances) must be element-equal.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.ops import screen_pallas as jops
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring import screen_tiles as j_tiles
from pharmaconet_tpu.scoring import screen_v3 as j_v3
from pharmaconet_tpu.scoring.tiled_pack import build_tiled_batch as j_build_tiled
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_cuda
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import screen_tiles as t_tiles
from pharmaconet_tpu_torch.scoring import screen_v3 as t_v3
from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch as t_build_tiled

RTOL, ATOL = 2e-5, 1e-4


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=[1, 3], ids=["c1", "c3"])
def inputs(request):
    """Both packages' packed model and ligands from the same seeds."""
    c = request.param
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=10, seed=5))
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=10, seed=5))
    j_lig = bench.make_synthetic_ligands(24, num_conformers=c, seed=6)
    t_lig = synthetic.make_synthetic_ligands(24, num_conformers=c, seed=6)
    return j_pm, t_pm, j_lig, t_lig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("with_model", [True, False], ids=["meta_keys", "content_hash"])
def test_build_v3_layout_equal(inputs, with_model):
    """Both grouping paths (metadata keys, content hash) give arrays equal
    to the JAX package's, and so does the screener's bucketed build."""
    j_pm, t_pm, j_lig, t_lig = inputs
    jb, tb = jbs.build_batch(j_pm, j_lig), tbs.build_batch(t_pm, t_lig)
    jv = j_v3.build_v3_layout(jb, model=j_pm if with_model else None)
    tv = t_v3.build_v3_layout(tb, model=t_pm if with_model else None)
    for f in dataclasses.fields(tv):
        x, y = getattr(tv, f.name), getattr(jv, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name not in ("candidates",):
            assert x == y, f.name
    assert tv.g_cap >= 16 and tv.tab.shape[2] % 128 == 0
    jvb = jbs.BatchScreener(j_pm, engine="v3").build_vb(jb)
    tvb = tbs.BatchScreener(t_pm, engine="v3", device="cpu").build_vb(tb)
    for f in ("dt", "gid", "tab", "aux", "ends_padded", "pair_end_rows"):
        np.testing.assert_array_equal(getattr(tvb, f), getattr(jvb, f), err_msg=f)


def test_tile_distances_native_numpy_and_jax_equal(inputs):
    j_pm, t_pm, j_lig, t_lig = inputs
    jt, tt = j_build_tiled(j_pm, j_lig), t_build_tiled(t_pm, t_lig)
    native = t_tiles.tile_distances(tt.pos_blocks, tt.uv)
    plain = t_tiles.tile_distances(tt.pos_blocks, tt.uv, native=False)
    assert native.dtype == np.float32 and native.shape == (tt.uv.shape[0], tt.cmax, 1024)
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, j_tiles.tile_distances(jt.pos_blocks, jt.uv))


@pytest.mark.parametrize("form", ["rows", "pairs"])
def test_k2_score_tiles_v3_matches_jax(inputs, form):
    j_pm, t_pm, j_lig, t_lig = inputs
    jv = jbs.BatchScreener(j_pm, engine="v3").build_vb(jbs.build_batch(j_pm, j_lig))
    tv = tbs.BatchScreener(t_pm, engine="v3", device="cpu").build_vb(tbs.build_batch(t_pm, t_lig))
    jargs = [jnp.asarray(a) for a in (jv.dt, jv.gid, jv.tab, jv.aux)]
    targs = [_t(a) for a in (tv.dt, tv.gid, tv.tab, tv.aux)]
    kw = dict(depth=tv.depth, mn_cap=tv.mn_cap)
    if form == "rows":
        want = jops.score_tiles_v3_rows(*jargs, g_cap=jv.g_cap, interpret=True, **kw)
        got = screen_cuda.score_tiles_v3_rows(*targs, **kw)
    else:
        want = jops.score_tiles_v3_pairs(*jargs, jnp.asarray(jv.ends_padded),
                                         g_cap=jv.g_cap, interpret=True, **kw)
        got = screen_cuda.score_tiles_v3_pairs(*targs, _t(tv.ends_padded), **kw)
    assert_scores_close(got, want)
    ends = tv.pair_end_rows
    live = got[: len(ends)][ends >= 0] if form == "pairs" else got[ends[ends >= 0]]
    assert (live == -1.0).any() and (live > 0).any()
    assert screen_cuda.LAUNCHES["score_tiles_v3"] == 0  # CPU tensors run the plain version


def test_k3_score_tiles_fused_dt_matches_jax(inputs):
    j_pm, t_pm, j_lig, t_lig = inputs
    jt, tt = j_build_tiled(j_pm, j_lig), t_build_tiled(t_pm, t_lig)
    t = -(-tt.nst // 1024)
    dt = t_tiles.tile_distances(tt.pos_blocks[:t], tt.uv[:t])
    want = jops.score_tiles_fused_dt_rows(
        jnp.asarray(dt), jnp.asarray(jt.gtab[:t]), jnp.asarray(jt.aux[:t]),
        depth1=jt.depth1, depth2=jt.depth2, interpret=True,
    )
    got = screen_cuda.score_tiles_fused_dt_rows(
        _t(dt), _t(tt.gtab[:t]), _t(tt.aux[:t]), tt.depth1, tt.depth2
    )
    assert_scores_close(got, want)
    # the stored distances reproduce K1's in-tile rebuild
    k1 = screen_cuda.score_tiles_fused_rows(
        *(_t(a[:t]) for a in (tt.pos_blocks, tt.uv, tt.gtab, tt.aux)), tt.depth1, tt.depth2
    )
    ends = tt.pair_end_rows[tt.pair_end_rows >= 0]
    assert_scores_close(got[ends], k1[ends])
    assert (got[ends] == -1.0).any() and (got[ends] > 0).any()


def test_v3_engine_matches_jax_and_reference(inputs):
    j_pm, t_pm, j_lig, t_lig = inputs
    want = jbs.BatchScreener(j_pm, engine="v3", pallas_interpret=True).score_packed(j_lig)
    got = tbs.BatchScreener(t_pm, engine="v3", device="cpu").score_packed(t_lig)
    ref = tbs.BatchScreener(t_pm, engine="reference", device="cpu").score_packed(t_lig)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert max(want) > 0.0


def test_k2_shared_memory_limit():
    """A group table that cannot sit in one block's shared memory raises
    with the sizes; the default [16, 128] table fits at every conformer
    count the kernels take."""
    with pytest.raises(ValueError, match="shared memory"):
        screen_cuda.v3_shared_bytes(4, 512, 128)  # g_cap grown to 512: 256 KiB
    for c in range(1, screen_cuda.MAX_CONFORMERS + 1):
        assert screen_cuda.v3_shared_bytes(c, 16, 128) <= screen_cuda.MAX_SMEM
