"""The port's sharded screener (`pharmaconet_tpu_torch.parallel.screening`)
against the port's single-device `BatchScreener` and the JAX package's
`ShardedScreener`.

Meshes of CPU devices (`[torch.device("cpu")] * n`, n = 1 and 3) run the
sharding logic on the host; the JAX side runs on the conftest's virtual
CPU devices (`data_mesh(jax.devices()[:n])`), its Pallas kernels in
interpret mode. The corpus: the 10-cluster synthetic model (seed 3) and 45
synthetic ligands, 24 of 4 conformers and 21 of 2 interleaved (so the
shares need the common conformer slot count), with 3 cluster-less ligands
among them. Stores: every v3 variant the stored route has, v2 and v1, in
3 batches of 16.

On CPU tensors every kernel wrapper calls its plain twin in
`ops/screen_ref.py`, so counting those calls shows which kernel an engine
mapping runs on each share.

Tolerance: scores within rtol 2e-5 / atol 1e-4 (the repo tolerance) of
both references; cluster-less ligands score exactly 0.
"""

from __future__ import annotations

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import bench
from pharmaconet_tpu.parallel.mesh import data_mesh as jax_data_mesh
from pharmaconet_tpu.parallel.screening import ShardedScreener as JaxShardedScreener
from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu.scoring import tiled_store as jts
from pharmaconet_tpu_torch import synthetic
from pharmaconet_tpu_torch.ops import screen_ref
from pharmaconet_tpu_torch.parallel.screening import ShardedScreener
from pharmaconet_tpu_torch.scoring import batch_screen as tbs
from pharmaconet_tpu_torch.scoring import tiled_store as tts
from test_torch_tiled_store import _empty

TOL = dict(rtol=2e-5, atol=1e-4)
CPU = torch.device("cpu")
BATCH = 16
EMPTY_AT = (5, 20, 40)  # cluster-less ligands
# engine mapping: port flags, the JAX ShardedScreener flags of the same
# branch, and the plain kernel each share runs
MAPPINGS = {
    "k1": (dict(), dict(engine="pallas"), "score_tiles_fused_rows"),
    "k5_unpacked": (dict(native_pack=False), dict(engine="pallas", native_pack=False),
                    "gaussian_phase"),
    "k5_unfused": (dict(fused=False), dict(engine="pallas", pallas_fused=False),
                   "gaussian_phase"),
    "reference": (dict(engine="reference"), dict(engine="xla"), "score_blocks_device"),
    "v3": (dict(engine="v3"), dict(engine="v3"), "score_tiles_v3_rows"),
}
KERNELS = ("score_tiles_fused_rows", "score_tiles_fused_dt_rows", "score_tiles_v3_rows",
           "score_blocks_fused", "gaussian_phase", "score_blocks_device")
STORES = {  # kind -> (writer, keyword arguments)
    "v3": ("v3", {}),
    "v3_dense": ("v3", dict(leaf_wire="dense")),
    "v3_single": ("v3", dict(leaf_layout="single")),
    "v3_noleaf": ("v3", dict(bake_leaves=False)),
    "v2": ("v2", {}),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _library(pkg, mod):
    lig = [x for pair in zip(mod.make_synthetic_ligands(24, num_conformers=4, seed=4),
                             mod.make_synthetic_ligands(24, num_conformers=2, seed=6))
           for x in pair][:45]
    for i in EMPTY_AT:
        lig.insert(i, _empty(pkg))
    return lig


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both packages' model and ligands, and every store kind written by
    the port: {kind: path}."""
    root = tmp_path_factory.mktemp("sharded")
    t_pm = tbs.PackedModel.from_model(synthetic.make_synthetic_model(num_clusters=10, seed=3))
    j_pm = jbs.PackedModel.from_model(bench.make_synthetic_model(num_clusters=10, seed=3))
    t_lig, j_lig = _library(tbs, synthetic), _library(jbs, bench)
    names = [f"l{i:02d}" for i in range(len(t_lig))]
    stores = {}
    for kind, (writer, kw) in STORES.items():
        stores[kind] = root / kind
        if writer == "v2":
            tts.write_tiled_store(stores[kind], t_pm, t_lig, names, batch_size=BATCH,
                                  verbose=False)
        else:
            tts.write_v3_store(stores[kind], t_pm, t_lig, names, batch_size=BATCH,
                               verbose=False, device="cpu", **kw)
    stores["v1"] = root / "v1"  # a v2 store without its distances
    shutil.copytree(stores["v2"], stores["v1"])
    for f in stores["v1"].rglob("dt.npy"):
        f.unlink()
    return dict(t_pm=t_pm, j_pm=j_pm, t_lig=t_lig, j_lig=j_lig, stores=stores)


@pytest.fixture
def launches(monkeypatch):
    """Calls of each plain kernel twin (one per launch the wrapper would
    make on the card)."""
    counts = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        mod = tbs if name == "score_blocks_device" else screen_ref
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return counts


def _jax_sharded(corpus, n_dev, engine, **flags):
    """The JAX sharded screener; `flags` (native_pack, pallas_fused) are
    attributes its constructor does not take."""
    screener = JaxShardedScreener(corpus["j_pm"], mesh=jax_data_mesh(jax.devices()[:n_dev]),
                                  engine=engine, pallas_interpret=True)
    for name, value in flags.items():
        setattr(screener, name, value)
    return screener


@pytest.mark.parametrize("n_dev", [1, 3])
@pytest.mark.parametrize("mapping", list(MAPPINGS))
def test_engine_mapping_equals_single_device_and_jax(corpus, launches, mapping, n_dev):
    """Each engine mapping runs its kernel once per share and scores as the
    single-device screener and the JAX sharded screener do."""
    flags, jax_flags, kernel = MAPPINGS[mapping]
    want = tbs.BatchScreener(corpus["t_pm"], device="cpu", **flags).score_packed(corpus["t_lig"])
    for k in launches:
        launches[k] = 0
    got = ShardedScreener(corpus["t_pm"], mesh=[CPU] * n_dev, **flags).score_packed(
        corpus["t_lig"])
    assert launches == {k: n_dev if k == kernel else 0 for k in KERNELS}
    np.testing.assert_allclose(got, want, **TOL)
    assert [got[i] for i in EMPTY_AT] == [0.0] * len(EMPTY_AT)
    assert sum(s > 0 for s in got) >= 30
    jax_got = _jax_sharded(corpus, n_dev, **jax_flags).score_packed(corpus["j_lig"])
    np.testing.assert_allclose(got, jax_got, **TOL)


def test_few_live_ligands_take_the_single_device_path(corpus, launches):
    """Fewer live ligands than devices: one K1 launch on the home device;
    no live ligand at all: zeros and no launch."""
    lig = corpus["t_lig"][:2] + [_empty(tbs)] * 4
    got = ShardedScreener(corpus["t_pm"], mesh=[CPU] * 3).score_packed(lig)
    assert launches["score_tiles_fused_rows"] == 1
    want = tbs.BatchScreener(corpus["t_pm"], device="cpu").score_packed(lig)
    assert got == want and got[2:] == [0.0] * 4
    jax_got = _jax_sharded(corpus, 3, engine="pallas").score_packed(
        corpus["j_lig"][:2] + [_empty(jbs)] * 4)
    np.testing.assert_allclose(got, jax_got, **TOL)
    launches["score_tiles_fused_rows"] = 0
    assert ShardedScreener(corpus["t_pm"], mesh=[CPU] * 3).score_packed(
        [_empty(tbs)] * 5) == [0.0] * 5
    assert launches["score_tiles_fused_rows"] == 0


def _loads(corpus, kind, pkg):
    pm = corpus["t_pm"] if pkg == "port" else corpus["j_pm"]
    store = (tts if pkg == "port" else jts).TiledStore(corpus["stores"][kind.split("+")[0]], pm)
    sbs = [store.load(bi) for bi in range(store.n_batches)]
    if kind.endswith("+nocompaction"):  # K2 rows, pairs compacted on the host
        sbs = [dataclasses.replace(sb, ends_padded=None) for sb in sbs]
    return sbs


STORE_KERNEL = {"v2": "score_tiles_fused_dt_rows", "v1": "score_tiles_fused_rows"}


@pytest.mark.parametrize("n_dev", [1, 3])
@pytest.mark.parametrize("kind", [*STORES, "v3_noleaf+nocompaction", "v1"])
def test_stored_group_equals_single_batches_and_jax(corpus, launches, kind, n_dev):
    """score_stored_group over groups of n_dev batches: one kernel launch
    per batch, scores equal to score_stored batch by batch and to the JAX
    grouped program's."""
    sbs = _loads(corpus, kind, "port")
    assert len(sbs) == 3 and not any(sb.empty for sb in sbs)
    single = tbs.BatchScreener(corpus["t_pm"], device="cpu")
    want = [single.score_stored(sb) for sb in sbs]
    for k in launches:
        launches[k] = 0
    screener = ShardedScreener(corpus["t_pm"], mesh=[CPU] * n_dev)
    got = [s for g in range(0, 3, n_dev) for s in screener.score_stored_group(sbs[g:g + n_dev])]
    kernel = STORE_KERNEL.get(kind, "score_tiles_v3_rows")
    assert launches == {k: 3 if k == kernel else 0 for k in KERNELS}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert got[0][EMPTY_AT[0]] == 0.0
    jbatches = _loads(corpus, kind, "jax")
    jax_screener = _jax_sharded(corpus, n_dev, engine="v3")
    jax_got = [s for g in range(0, 3, n_dev)
               for s in jax_screener.score_stored_group(jbatches[g:g + n_dev])]
    for g, j in zip(got, jax_got):
        np.testing.assert_allclose(g, j, **TOL)


@pytest.mark.parametrize("group", [("v3", "v3_single", "v3_noleaf"),
                                   ("v3_dense", "v3_noleaf+nocompaction", "v3_single")],
                         ids=["leaves-stripped", "all-stripped"])
def test_mixed_stored_group(corpus, launches, group):
    """A group whose batches differ in their leaves runs K2 alone on each,
    compacting pairs on the device only where every batch can; scores equal
    each batch's own score_stored and the JAX grouped program's."""
    sbs = [_loads(corpus, kind, "port")[k] for k, kind in enumerate(group)]
    single = tbs.BatchScreener(corpus["t_pm"], device="cpu")
    want = [single.score_stored(sb) for sb in sbs]
    screener = ShardedScreener(corpus["t_pm"], mesh=[CPU] * 3)
    calls = []
    real = screener._shares[0].dispatch_stored

    def spy(sb):
        calls.append((sb.leaf2_ps, sb.leaf_buckets, sb.ends_padded is None))
        return real(sb)

    screener._shares[0].dispatch_stored = spy
    for k in launches:
        launches[k] = 0
    got = screener.score_stored_group(sbs)
    assert launches == {k: 3 if k == "score_tiles_v3_rows" else 0 for k in KERNELS}
    assert calls == [(None, None, "nocompaction" in "".join(group))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    jbatches = [_loads(corpus, kind, "jax")[k] for k, kind in enumerate(group)]
    jax_got = _jax_sharded(corpus, 3, engine="v3").score_stored_group(jbatches)
    for g, j in zip(got, jax_got):
        np.testing.assert_allclose(g, j, **TOL)


def test_stored_group_contract(corpus):
    screener = ShardedScreener(corpus["t_pm"], mesh=[CPU] * 3)
    sbs = _loads(corpus, "v3", "port")
    with pytest.raises(ValueError, match="mesh of 3"):
        screener.score_stored_group(sbs[:2])
    empty = dataclasses.replace(sbs[2], dt=None)
    with pytest.raises(ValueError, match="non-empty"):
        screener.score_stored_group([sbs[0], sbs[1], empty])


def test_shares_own_device_state(corpus):
    """Each share has its own screener: its device, its stream and its pack
    buffers, so one share's pack never overwrites another's arrays before
    that share's host tail reads them."""
    screener = ShardedScreener(corpus["t_pm"], mesh=[CPU, "cpu"])
    assert screener.mesh == [CPU, CPU] and screener.device == CPU
    a, b = screener._shares
    assert a is not b and a._pack_buffers is not b._pack_buffers
    assert a._pack_buffers is not screener._pack_buffers
    screener.score_packed(corpus["t_lig"])
    assert a._pack_buffers and b._pack_buffers
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedScreener(corpus["t_pm"])  # every visible card: none


def test_shares_launch_at_their_own_shapes(corpus, monkeypatch):
    """No common padding: each share's K1 launch takes the tiles and scan
    depths of its own one-pass pack (the JAX package pads every shard to
    the widest and deepest, since shard_map stacks them)."""
    from pharmaconet_tpu_torch.parallel.mesh import contiguous_shares
    from pharmaconet_tpu_torch.scoring.batch_screen import _used_tiles
    from pharmaconet_tpu_torch.scoring.tiled_pack import build_tiled_batch

    seen = []
    real = screen_ref.score_tiles_fused_rows
    monkeypatch.setattr(screen_ref, "score_tiles_fused_rows",
                        lambda pos, uv, gtab, aux, d1, d2: seen.append(
                            (pos.shape[0], d1, d2)) or real(pos, uv, gtab, aux, d1, d2))
    ShardedScreener(corpus["t_pm"], mesh=[CPU] * 3).score_packed(corpus["t_lig"])
    live = [p for p in corpus["t_lig"] if p.clusters]
    want = []
    for a, b in contiguous_shares(len(live), 3):
        tb = build_tiled_batch(corpus["t_pm"], live[a:b], cmax=4)
        want.append((_used_tiles(tb), tb.depth1, tb.depth2))
    assert seen == want
    assert len(set(seen)) > 1  # the shares differ: nothing was padded to a common shape
