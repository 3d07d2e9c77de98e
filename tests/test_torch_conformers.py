"""More conformers than one CUDA launch takes (C > 8): the wrappers of K1-K5
score groups of at most 8 conformer columns and join the outputs
(`screen_cuda.by_conformer_groups`).

On the CPU the wrappers take their plain versions over all C at once, so
these tests run the grouping helper itself with the plain twins at C = 9,
12 and 16, and hold it against the JAX function (Pallas in interpret mode)
on the same numpy-seeded inputs: rtol 2e-5 / atol 1e-4 with equal -1
masks, pass counts exactly equal. A 12-conformer library is also screened
end to end by both packages' `screening --library`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.cli.screening import build_parser as j_parser
from pharmaconet_tpu.cli.screening import main as j_main
from pharmaconet_tpu.ops import screen_pallas as jops
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring.library import save_library as j_save_library
from pharmaconet_tpu.scoring.tiled_pack import build_tiled_batch as j_build_tiled
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.cli import screening as t_cli
from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring.screen_tiles import tile_distances
from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch as t_build_tiled

RTOL, ATOL = 2e-5, 1e-4
MANY = [9, 12, 16]


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", params=MANY, ids=[f"c{c}" for c in MANY])
def inputs(request):
    """Both packages' packed model and `c`-conformer ligands from the same
    seeds."""
    c = request.param
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=8, seed=5))
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=8, seed=5))
    j_lig = bench.make_synthetic_ligands(12, num_conformers=c, seed=6 + c)
    t_lig = synthetic.make_synthetic_ligands(12, num_conformers=c, seed=6 + c)
    return c, j_pm, t_pm, j_lig, t_lig


def test_conformer_groups_cover_in_near_equal_groups():
    for c in range(1, 41):
        groups = screen_cuda.conformer_groups(c)
        assert groups[0][0] == 0 and groups[-1][1] == c
        assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
        sizes = [c1 - c0 for c0, c1 in groups]
        assert len(groups) == -(-c // screen_cuda.MAX_CONFORMERS)
        assert max(sizes) <= screen_cuda.MAX_CONFORMERS and max(sizes) - min(sizes) <= 1
    assert screen_cuda.conformer_groups(12) == [(0, 6), (6, 12)]
    assert screen_cuda.conformer_groups(9, cap=4) == [(0, 3), (3, 6), (6, 9)]


def test_k1_groups_match_jax(inputs):
    c, j_pm, t_pm, j_lig, t_lig = inputs
    jt, tt = j_build_tiled(j_pm, j_lig), t_build_tiled(t_pm, t_lig)
    assert tt.cmax == c
    want = jops.score_tiles_fused_rows(*(jnp.asarray(a) for a in (
        jt.pos_blocks, jt.uv, jt.gtab, jt.aux)), depth1=jt.depth1, depth2=jt.depth2,
        interpret=True)
    pos, uv, gtab, aux = (_t(a) for a in (tt.pos_blocks, tt.uv, tt.gtab, tt.aux))
    got = screen_cuda.by_conformer_groups(
        lambda p: screen_ref.score_tiles_fused_rows(p, uv, gtab, aux, tt.depth1, tt.depth2),
        pos, 3, 1)
    assert got.shape == (tt.uv.size, c)
    assert_scores_close(got, want)
    live = np.asarray(want)[tt.pair_end_rows[tt.pair_end_rows >= 0]]
    assert (live == -1.0).any() and (live > 0).any()
    # the wrapper on CPU tensors: the plain version over all C at once
    assert_scores_close(screen_cuda.score_tiles_fused_rows(pos, uv, gtab, aux, tt.depth1,
                                                           tt.depth2), want)


def test_k3_groups_match_jax(inputs):
    c, j_pm, t_pm, j_lig, t_lig = inputs
    jt, tt = j_build_tiled(j_pm, j_lig), t_build_tiled(t_pm, t_lig)
    t = -(-tt.nst // 1024)
    dt = tile_distances(tt.pos_blocks[:t], tt.uv[:t])
    want = jops.score_tiles_fused_dt_rows(
        jnp.asarray(dt), jnp.asarray(jt.gtab[:t]), jnp.asarray(jt.aux[:t]),
        depth1=jt.depth1, depth2=jt.depth2, interpret=True)
    gtab, aux = _t(tt.gtab[:t]), _t(tt.aux[:t])
    got = screen_cuda.by_conformer_groups(
        lambda d: screen_ref.score_tiles_fused_dt_rows(d, gtab, aux, tt.depth1, tt.depth2),
        _t(dt), 1, 1)
    assert_scores_close(got, want)


def test_k2_groups_match_jax(inputs):
    c, j_pm, t_pm, j_lig, t_lig = inputs
    jv = jbs.BatchScreener(j_pm, engine="v3").build_vb(jbs.build_batch(j_pm, j_lig))
    tv = tbs.BatchScreener(t_pm, engine="v3", device="cpu").build_vb(tbs.build_batch(t_pm, t_lig))
    kw = dict(depth=tv.depth, mn_cap=tv.mn_cap)
    want = jops.score_tiles_v3_rows(*(jnp.asarray(a) for a in (jv.dt, jv.gid, jv.tab, jv.aux)),
                                    g_cap=jv.g_cap, interpret=True, **kw)
    dt, gid, tab, aux = (_t(a) for a in (tv.dt, tv.gid, tv.tab, tv.aux))
    assert dt.shape[1] == c
    got = screen_cuda.by_conformer_groups(
        lambda d: screen_ref.score_tiles_v3_rows(d, gid, tab, aux, **kw), dt, 1, 1)
    assert_scores_close(got, want)


@pytest.mark.parametrize("cap", [8, 3])
def test_k4_k5_groups_match_jax(inputs, cap):
    """K4 ([C, NS]) and K5 (stacked [2C, NS]: scores, then pass counts),
    also in groups of 3 (four or more groups)."""
    c, j_pm, t_pm, j_lig, t_lig = inputs
    jscr = jbs.BatchScreener(j_pm, engine="pallas", pallas_interpret=True)
    jtile = jscr.device_args_pallas(jbs.build_batch(j_pm, j_lig))
    ttile = tbs.BatchScreener(t_pm, device="cpu").device_args_tiled(tbs.build_batch(t_pm, t_lig))
    names = ("pos_blocks", "uv_packed", "muT", "invT", "winvT")
    rows = ("flags_block", "flags_pair", "end_mn_inv", "end_mn_half", "end_fail_gate",
            "thr_ns", "self_ns")
    d = dict(depth1=jtile.depth1, depth2=jtile.depth2)
    want4 = jops.score_blocks_pallas_fused(*(jnp.asarray(getattr(jtile, f)) for f in names + rows),
                                           interpret=True, **d)
    want5 = jops.gaussian_phase_pallas(*(jnp.asarray(getattr(jtile, f)) for f in names),
                                       interpret=True)
    pos, *base = (_t(getattr(ttile, f)) for f in names)
    r = [_t(getattr(ttile, f)).float() for f in rows]
    got4 = screen_cuda.by_conformer_groups(
        lambda p: screen_ref.score_blocks_fused(p, *base, *r, ttile.depth1, ttile.depth2),
        pos, 3, 0, cap=cap)
    got5 = screen_cuda.by_conformer_groups(
        lambda p: screen_ref.gaussian_phase(p, *base), pos, 3, 0, stacked=True, cap=cap)
    assert got4.shape[0] == c and got5.shape[0] == 2 * c
    assert_scores_close(got4, want4)
    np.testing.assert_array_equal(got5[c:].numpy(), np.asarray(want5)[c:])
    assert_scores_close(got5, want5)


def test_library_of_12_conformers_screens_as_in_jax(tmp_path):
    """`screening --library` over 12-conformer ligands: the port's CSV
    against the JAX package's, same names, scores within tolerance."""
    bench.make_synthetic_model(num_clusters=10, seed=3).save(str(tmp_path / "model.pm"))
    ligands = bench.make_synthetic_ligands(20, num_conformers=12, seed=4)
    j_save_library(tmp_path / "lib.npz", ligands, [f"l{i:02d}" for i in range(len(ligands))])
    common = ["-p", str(tmp_path / "model.pm"), "--library", str(tmp_path / "lib.npz"),
              "--batch_size", "8"]
    assert j_main(j_parser().parse_args([*common, "-o", str(tmp_path / "jax.csv")])) == 0
    assert t_cli.main(t_cli.build_parser().parse_args(
        [*common, "-o", str(tmp_path / "port.csv"), "--device", "cpu"])) == 0
    rows = [dict(line.rsplit(",", 1) for line in (tmp_path / f).read_text().splitlines()[1:])
            for f in ("port.csv", "jax.csv")]
    assert rows[0].keys() == rows[1].keys() and len(rows[0]) == len(ligands)
    names = sorted(rows[1])
    got, want = ([float(r[n]) for n in names] for r in rows)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert max(want) > 0.0
