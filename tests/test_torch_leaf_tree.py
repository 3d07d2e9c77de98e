"""The port's leaf chain (scoring/leaf_tree.py) against the JAX package.

The numpy bake half must give arrays equal to pharmaconet_tpu's on the same
batch and pair table (stores move between the packages). The torch device
half (leaf2_scores_multi on both wires, leaf2_scores_device) must score like
the JAX functions on the same kernel rows and bake, and like the host DFS
it replaces, within rtol 2e-5 / atol 1e-4. Plus the guards: TF32 matrix
products and the int32 pad sentinel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring import leaf_tree as jlt
from pharmaconet_tpu.scoring import screen_v3 as j_v3
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_cuda
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import leaf_tree as tlt
from pharmaconet_tpu_torch.scoring import screen_v3 as t_v3

RTOL, ATOL = 2e-5, 1e-4
NB = 64  # ligands in the batch (the scatter target length)


def _bucket_specs(nref, leaves):
    """Width classes, capacities and leaf caps as write_v3_store sizes them
    for a one-batch store."""
    baked = leaves > 0
    edges = tlt.choose_bucket_edges(nref[baked])
    ki = np.searchsorted(edges, nref[baked])
    counts = np.bincount(ki, minlength=len(edges))
    lmaxs = np.zeros(len(edges), np.int64)
    np.maximum.at(lmaxs, ki, leaves[baked])
    lmaxs = np.maximum.accumulate(lmaxs)
    rnd8 = lambda v: int(((max(int(v), 1) + 7) // 8) * 8)  # noqa: E731
    return [(rnd8(counts[j]), rnd8(lmaxs[j]), int(edges[j]))
            for j in range(len(edges)) if counts[j] > 0]


@pytest.fixture(scope="module")
def case():
    """One v3 batch of each package from the same seeds, the port's final
    pair table (reference engine, empty pairs 0, pruned -1), its leaf
    enumeration, and the K2 rows (plain version) the device half reads."""
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=20, seed=0))
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=20, seed=0))
    t_lig = synthetic.make_synthetic_ligands(NB, seed=1)
    j_lig = bench.make_synthetic_ligands(NB, seed=1)
    scr = tbs.BatchScreener(t_pm, engine="reference", device="cpu")
    batch = tbs.build_batch(t_pm, t_lig)
    vb = t_v3.build_v3_layout(batch, model=t_pm)
    jvb = j_v3.build_v3_layout(jbs.build_batch(j_pm, j_lig), model=j_pm)
    table = tbs.compact_pair_table(batch, scr._to_host(scr.run_device(batch)))
    prune = tbs.host_prune_mask(vb, t_pm)
    table[: len(prune)][prune] = -1.0
    assign, offsets = tlt.enumerate_leaves(vb, table)
    rows = screen_cuda.score_tiles_v3_rows(
        *(torch.from_numpy(a) for a in (vb.dt, vb.gid, vb.tab, vb.aux)),
        depth=vb.depth, mn_cap=vb.mn_cap,
    )
    dfs = tlt._dfs_arrays(vb)
    nref, leaves = tlt.leaf_window_stats(assign, offsets, dfs[2], dfs[3])
    return dict(vb=vb, jvb=jvb, table=table, prune=prune, assign=assign,
                offsets=offsets, rows=rows, dfs=dfs, nref=nref, leaves=leaves,
                specs=_bucket_specs(nref, leaves))


def _bake(mod, c, **kw):
    vb = c["vb"]
    return mod.build_leaf_buckets(
        c["assign"], c["offsets"], *c["dfs"], vb.pair_end_rows, c["prune"],
        bucket_specs=c["specs"], nbt=vb.dt.shape[0] * 1024, batch_size=NB, **kw,
    )


def _assert_fields_equal(a, b):
    for name, x in vars(a).items():
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, getattr(b, name), err_msg=name)
        elif not isinstance(x, list):
            assert x == getattr(b, name), name


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_enumerate_leaves_equal_jax(case, native):
    t_assign, t_off = tlt.enumerate_leaves(case["vb"], case["table"], native=native)
    j_assign, j_off = jlt.enumerate_leaves(case["jvb"], case["table"])
    np.testing.assert_array_equal(t_assign, j_assign)
    np.testing.assert_array_equal(t_off, j_off)
    assert len(t_assign) > NB


def test_bake_equal_jax(case):
    """Window stats, sign flags, bucket edges, the bucketed and the
    single-window bakes and the sparse wire equal the JAX package's."""
    vb, jvb = case["vb"], case["jvb"]
    np.testing.assert_array_equal(
        tlt.near_zero_gate_flags(vb, case["table"], vb.pair_end_rows, case["prune"]),
        jlt.near_zero_gate_flags(jvb, case["table"], jvb.pair_end_rows, case["prune"]))
    j_stats = jlt.leaf_window_stats(case["assign"], case["offsets"], *case["dfs"][2:])
    for x, y in zip((case["nref"], case["leaves"]), j_stats):
        np.testing.assert_array_equal(x, y)
    assert tlt.choose_bucket_edges(case["nref"]) == jlt.choose_bucket_edges(case["nref"])
    t_bake, j_bake = _bake(tlt, case), _bake(jlt, case)
    assert len(t_bake.buckets) == len(case["specs"]) >= 2
    for tb, jb in zip(t_bake.buckets, j_bake.buckets):
        _assert_fields_equal(tb, jb)
        wk = tb.prune_w.shape[1]
        for plane in (tb.plane_score, tb.plane_cross):
            np.testing.assert_array_equal(tlt.planes_to_sparse(plane, wk),
                                          jlt.planes_to_sparse(plane, wk))
    _assert_fields_equal(t_bake, j_bake)
    nbt = vb.dt.shape[0] * 1024
    dense = [mod.build_leaf_dense(case["assign"], case["offsets"], *case["dfs"],
                                  vb.pair_end_rows, case["prune"], l_cap=160, w_cap=128,
                                  nbt=nbt, batch_size=NB)
             for mod in (tlt, jlt)]
    _assert_fields_equal(*dense)


def _bucket_tuples(bake, wire):
    """Store-form bucket tuples (what TiledStore loads) of a bake."""
    out = []
    for b in bake.buckets:
        if wire == "dense":
            out.append((b.ends2, b.plane_score, b.plane_cross, b.prune_w, b.conf, b.lig_idx))
        else:
            wk = b.prune_w.shape[1]
            out.append((b.ends2, tlt.planes_to_sparse(b.plane_score, wk),
                        tlt.planes_to_sparse(b.plane_cross, wk), b.prune_w, b.conf,
                        b.lig_idx, np.zeros((b.plane_score.shape[1], 0), np.uint8)))
    return out


@pytest.mark.parametrize("wire", ["dense", "sparse"])
def test_leaf2_scores_multi_matches_jax_and_dfs(case, wire):
    bake = _bake(tlt, case, force_demote=np.arange(NB) % 9 == 0)
    buckets = _bucket_tuples(bake, wire)
    rows = case["rows"]
    got, got_out = tlt.leaf2_scores_multi(
        rows, torch.from_numpy(bake.out_ends),
        tuple(tuple(torch.from_numpy(a) for a in b) for b in buckets), nb=NB)
    want, want_out = jlt.leaf2_scores_multi(
        jnp.asarray(rows.numpy()), jnp.asarray(bake.out_ends),
        tuple(tuple(jnp.asarray(a) for a in b) for b in buckets), nb=NB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    mirror, _ = tlt.leaf2_scores_multi_host(rows.numpy(), bake, NB)
    np.testing.assert_allclose(got.numpy(), mirror, rtol=RTOL, atol=ATOL)

    # the baked leaves score like the DFS over the same kernel rows; the
    # demoted ligands (outliers) score 0 here and in the DFS's stead
    table = tbs.compact_pair_table_rows(rows.numpy(), case["vb"].pair_end_rows)
    table[case["prune"]] = -1.0
    dfs = np.asarray(tbs._dfs_scores(case["vb"], table))
    baked = np.zeros(NB, bool)
    for b in bake.buckets:
        baked[b.lig_idx[b.lig_idx < NB]] = True
    assert set(bake.out_live) == set(np.nonzero(np.arange(NB) % 9 == 0)[0])
    np.testing.assert_allclose(got.numpy()[baked], dfs[baked], rtol=RTOL, atol=ATOL)
    assert (got.numpy()[~baked] == 0).all() and dfs[baked].max() > 0


def test_leaf2_scores_device_matches_jax(case):
    vb, rows = case["vb"], case["rows"]
    lb = tlt.build_leaf_dense(case["assign"], case["offsets"], *case["dfs"],
                              vb.pair_end_rows, case["prune"], l_cap=160, w_cap=128,
                              nbt=vb.dt.shape[0] * 1024, batch_size=NB)
    conf = np.pad(case["dfs"][1].astype(np.int32), (0, NB - len(case["dfs"][1])))
    arrays = (lb.ends2, lb.plane_score, lb.plane_cross, lb.prune_w, conf, lb.out_ends)
    got, got_out = tlt.leaf2_scores_device(rows, *(torch.from_numpy(a) for a in arrays))
    want, want_out = jlt.leaf2_scores_device(
        jnp.asarray(rows.numpy()), *(jnp.asarray(a) for a in arrays), w_cap=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    mirror, _ = tlt.leaf2_scores_host(rows.numpy(), lb, conf)
    np.testing.assert_allclose(got.numpy(), mirror, rtol=RTOL, atol=ATOL)
    assert got.max() > 0


def test_dense_and_sparse_wires_score_equal(case):
    """The two wires of one bake rebuild the same planes: the device chain
    gives identical scores and outlier rows on both."""
    bake = _bake(tlt, case)
    out_ends = torch.from_numpy(bake.out_ends)
    got = [tlt.leaf2_scores_multi(
               case["rows"], out_ends,
               tuple(tuple(torch.from_numpy(a) for a in b) for b in _bucket_tuples(bake, wire)),
               nb=NB)
           for wire in ("dense", "sparse")]
    np.testing.assert_array_equal(got[0][0].numpy(), got[1][0].numpy())
    np.testing.assert_array_equal(got[0][1].numpy(), got[1][1].numpy())
    assert got[0][0].max() > 0


@pytest.mark.parametrize("flag", ["allow_tf32", "matmul_precision"])
def test_tf32_matmuls_raise(case, flag):
    bake = _bake(tlt, case)
    buckets = tuple(tuple(torch.from_numpy(a) for a in b) for b in _bucket_tuples(bake, "sparse"))
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    old_precision = torch.get_float32_matmul_precision()
    try:
        if flag == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-f32"):
            tlt.leaf2_scores_multi(case["rows"], torch.from_numpy(bake.out_ends), buckets, nb=NB)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
        torch.set_float32_matmul_precision(old_precision)
    tlt.leaf2_scores_multi(case["rows"], torch.from_numpy(bake.out_ends), buckets, nb=NB)


def test_sparse_pad_sentinel_must_fit_int32():
    """bk*lk*wk is the sparse wire's int32 pad value: a plane of 2**31
    entries raises, in the check and in the device chain, before any
    scatter."""
    tlt.check_sparse_size(2**31 - 1)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tlt.check_sparse_size(2**31)
    bk, lk, wk = 2**15, 2**8, 2**8
    bucket = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
              torch.zeros(1, dtype=torch.int32), torch.zeros(bk, wk, dtype=torch.bool),
              torch.ones(bk, dtype=torch.int32), torch.zeros(bk, dtype=torch.int32),
              torch.zeros(lk, 0, dtype=torch.uint8))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tlt.leaf2_scores_multi(torch.zeros(8, 2), torch.zeros(8, dtype=torch.int32),
                               (bucket,), nb=4)
