"""The port's sharded modeler and segmenter (`pharmaconet_tpu_torch.parallel.modeling`)
against the port's single-pocket path and the JAX package's sharded
classes.

Meshes of CPU devices (`[torch.device("cpu")] * n`, n = 1 and 3) run the
sharding logic on the host; the JAX side runs on the conftest's virtual
CPU devices (`data_mesh(jax.devices()[:n])`). The network is the micro
trunk of `test_torch_training.micro_setup` (embed 8, grid 16, every gate
open, segmentation chunks of 4), on copies of one synthetic pocket at three
centres 0.7 A apart.

Tolerances: the sharded infos equal the port's single path element by
element (the same functions on the same arrays, chunk by chunk); against
the JAX sharded classes, `test_torch_modeling.py`'s: the hotspot lists
equal, scores within 1e-6, maps within atol 1e-5.
"""

from __future__ import annotations

import pickle

import jax
import numpy as np
import pytest
import torch

from pharmaconet_tpu.parallel.mesh import data_mesh as jax_data_mesh
from pharmaconet_tpu.parallel.modeling import ShardedModeler as JaxShardedModeler
from pharmaconet_tpu.parallel.modeling import ShardedSegmenter as JaxShardedSegmenter
from pharmaconet_tpu_torch.ops import voxelize as voxelize_ref
from pharmaconet_tpu_torch.parallel.modeling import ShardedModeler, ShardedSegmenter
from test_torch_modeling import _assert_same_hotspots
from test_torch_training import micro_setup

CPU = torch.device("cpu")
POCKETS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    s = micro_setup(tmp_path_factory.mktemp("shardmodel"), pockets=POCKETS)
    s.jobs = [(s.protein_dir / f"{c}.pdb", None, s.centers[c]) for c in s.codes]
    s.datas = [s.port.parse(p, center=c) for p, _, c in s.jobs]
    s.single = [s.port.create_density_maps(d) for d in s.datas]
    s.jax_datas = [s.jax_net.parse(p, center=c) for p, _, c in s.jobs]
    return s


@pytest.fixture
def voxelizations(monkeypatch):
    """Calls of K6's plain version (the wrapper's CPU route)."""
    calls = []
    real = voxelize_ref.voxelize
    monkeypatch.setattr(voxelize_ref, "voxelize", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _assert_equal_infos(got: list, want: list):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            if key == "point_map":
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("n_dev", [1, 3])
def test_modeler_equals_single_path_and_jax(setup, voxelizations, n_dev):
    """Pockets in contiguous shares over the mesh: each pocket's infos
    equal create_density_maps's element by element, K6 runs once per
    pocket, and the infos match the JAX ShardedModeler's."""
    got = ShardedModeler(setup.port, mesh=[CPU] * n_dev).create_density_maps_batch(setup.datas)
    assert len(voxelizations) == POCKETS
    assert len(got) == POCKETS
    for infos, want in zip(got, setup.single):
        _assert_equal_infos(infos, want)
    assert max(len(infos) for infos in got) > setup.port.max_hotspots  # overflow slabs in JAX
    jax_got = JaxShardedModeler(setup.jax_net, mesh=jax_data_mesh(jax.devices()[:n_dev])) \
        .create_density_maps_batch(setup.jax_datas)
    for infos, want in zip(got, jax_got):
        _assert_same_hotspots(infos, want)
    assert ShardedModeler(setup.port, mesh=[CPU] * 3).create_density_maps_batch([]) == []


def test_run_batch_equals_run(setup):
    """run_batch parses on the host and models every job (more jobs than
    devices, uneven shares): each .pm state equals PharmacoNet.run's."""
    jobs = setup.jobs + setup.jobs[:1]
    models = ShardedModeler(setup.port, mesh=[CPU] * 3).run_batch(jobs)
    assert len(models) == len(jobs)
    for model, (path, ref, center) in zip(models, jobs):
        want = setup.port.run(path, ref_ligand_path=ref, center=center)
        assert pickle.dumps(model.__getstate__()) == pickle.dumps(want.__getstate__())


@pytest.mark.parametrize("n_dev", [1, 3])
def test_segmenter_equals_single_path_and_jax(setup, voxelizations, monkeypatch, n_dev):
    """One pocket's kept tokens padded to a multiple of n_dev * chunk, each
    device a contiguous share of whole chunks (chunks of padding alone
    skipped): the infos equal create_density_maps's element by element and
    match the JAX ShardedSegmenter's. Chunks of 2 give each of 3 devices
    two chunks of the pocket's 10 kept tokens, the last one padding alone
    (the maps do not depend on the chunk size: `test_torch_modeling.py`)."""
    port, data = setup.port, setup.datas[0]
    chunk = 2
    monkeypatch.setattr(port, "segmentation_chunk", chunk)
    chunks = []
    real = type(port).segment
    monkeypatch.setattr(type(port), "segment",
                        lambda self, out, tokens, idx, valid: chunks.append(
                            (idx.copy(), valid.copy())) or real(self, out, tokens, idx, valid))
    got = ShardedSegmenter(port, mesh=[CPU] * n_dev).create_density_maps(data)
    assert len(voxelizations) == 1
    _assert_equal_infos(got, setup.single[0])
    kept = np.concatenate([idx[valid] for idx, valid in chunks])
    n = len(kept)
    assert n > 3 * chunk  # several chunks per device at n_dev = 3
    assert len(chunks) == -(-n // chunk) and all(len(idx) == chunk for idx, _ in chunks)
    assert -(-n // (n_dev * chunk)) * n_dev > len(chunks) or n_dev == 1  # one skipped
    np.testing.assert_array_equal(kept, np.nonzero(port.run_trunk(data)["keep"].numpy())[0])
    jax_got = JaxShardedSegmenter(setup.jax_net, mesh=jax_data_mesh(jax.devices()[:n_dev])) \
        .create_density_maps(setup.jax_datas[0])
    _assert_same_hotspots(got, jax_got)


def test_segmenter_run_and_no_kept_tokens(setup):
    seg = ShardedSegmenter(setup.port, mesh=[CPU] * 3)
    path, _, center = setup.jobs[1]
    model = seg.run(path, center=center)
    want = setup.port.run(path, center=center)
    assert pickle.dumps(model.__getstate__()) == pickle.dumps(want.__getstate__())
    out = setup.port.run_trunk(setup.datas[1])
    assert seg.segment(setup.datas[1], out, np.zeros(0, np.int64)) == []


def test_default_mesh_needs_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for cls in (ShardedModeler, ShardedSegmenter):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(setup.port)
