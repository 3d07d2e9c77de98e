"""The port's affinity-head trainer (`pharmaconet_tpu_torch.training`)
against the JAX package's, on synthetic pockets.

Both packages load one `.npz` of a micro network (embed 8, depths (1, 1),
heads (1, 2), window 2, token features 16, grid 16: a 3-level pyramid of 8
channels; the JAX package's random parameters) with every gate open
(score threshold 0, focus threshold 0), as `tests/test_training.py` sets
its micro trainer up; the pockets are copies of one
`synthetic.write_synthetic_pocket` pocket at four centres (the example
pockets of `tests/conftest.py` are not in the repo). The affinity model
has the JAX test's widths (hidden 16, 2 convolutions); the JAX trainer's
flax parameters are carried into the port (`training/convert.py`).

Tolerances, each with its reason:
  * dataset arrays: hotspot positions, masks, graph arrays and affinities
    equal; hotspot features and the pyramid within atol/rtol 1e-5 (the
    trunk in f32 on both sides, summation order apart, as in
    `test_torch_feature_extraction.py`);
  * forward and loss: rtol 2e-5 / atol 1e-4, the repo tolerance;
  * one step's loss rtol 1e-5, and every gradient leaf within 1e-4 of that
    leaf's largest entry;
  * the optimizer alone on identical gradients: every update within 1e-6
    of its leaf's largest (float32 formulas in the same order; Adam's first
    moment cancels where gradients change sign, so an ulp of its terms is
    measured against the leaf's scale, ~lr, not against the small result);
  * the parameters after 3 steps: within 1e-6 absolute (see
    `test_trainer_step_matches_jax`);
  * the port against itself on the CPU (resume, the async backend, the
    `.npz` round trip): bit for bit; `dp_step` on a 2-device CPU mesh
    against one device: loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5,
    as `tests/test_training.py` holds the JAX DP step.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pickle
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import load_npz_checkpoint as jax_load_npz
from pharmaconet_tpu.network.convert import save_npz_checkpoint as jax_save_npz
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu.training import dataset as jdataset
from pharmaconet_tpu.training.affinity_model import DevAffinityModel as JaxDevAffinityModel
from pharmaconet_tpu.training.config import Config as JaxConfig
from pharmaconet_tpu_torch import api
from pharmaconet_tpu_torch.network.convert import random_distributions
from pharmaconet_tpu_torch.proxy import gnn
from pharmaconet_tpu_torch.proxy.data import batch_graphs, smi2graph_list
from pharmaconet_tpu_torch.proxy.tacogfn import graph_batch_to_arrays
from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket
from pharmaconet_tpu_torch.training import Config, DevAffinityModel, Trainer
from pharmaconet_tpu_torch.training import convert, dataset
from pharmaconet_tpu_torch.training.train_step import Optimizer
from test_torch_proxy import _init

MICRO = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 16
KW = dict(max_hotspots=8, segmentation_chunk=4, grid_dim=GRID, model_kwargs=MICRO,
          score_threshold=0.0)
TOL = dict(rtol=2e-5, atol=1e-4)
FEATURE_TOL = dict(rtol=1e-5, atol=1e-5)
POOL = ["c1ccccc1", "CCO", "CC(=O)O", "c1ccncc1O", "CCN(CC)CC", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
        "O=C(C)Oc1ccccc1C(=O)O", "N[C@@H](C)C(=O)O", "C1CCCCC1", "c1ccc2ccccc2c1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One OpenMP thread per test process: the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def micro_setup(root: Path, pockets: int = 4) -> SimpleNamespace:
    """The micro network's `.npz`; `pockets` codes, each a copy of one
    synthetic pocket (seed 0) with its centre moved 0.7 A further along the
    diagonal and 3 + 2i ligands (graph buckets 8 and 12); their centres
    file, code list and ligand pickle; both packages' PharmacoNets on it
    (CPU, gates open)."""
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **MICRO))
    params = jax.tree.map(np.array, JaxPharmacoNet._random_params(holder, 3))
    jax_save_npz(root / "micro.npz", params, random_distributions())
    protein_dir = root / "proteins"
    protein_dir.mkdir()
    info = write_synthetic_pocket(root / "pocket.pdb", seed=0, cavity_radius=3.0,
                                  num_atoms=1200, outer_radius=20.0)
    codes, lines, ligands, centers = [], [], {}, {}
    for i in range(pockets):
        code = f"pocket{i}"
        (protein_dir / f"{code}.pdb").write_text((root / "pocket.pdb").read_text())
        codes.append(code)
        centers[code] = tuple(float(c) + 0.7 * i for c in info["center"])
        lines.append(",".join([code, *map(str, centers[code])]))
        rng = np.random.default_rng(i)
        ligands[code] = [(f"l{j}", POOL[(i + j) % len(POOL)], float(rng.uniform(-9, 1)))
                         for j in range(3 + 2 * i)]
    (root / "protein_info.csv").write_text("\n".join(lines))
    (root / "train_key.txt").write_text("\n".join(codes))
    with open(root / "ligand.pkl", "wb") as f:
        pickle.dump(ligands, f)
    port = api.get_pmnet_dev(device="cpu", weight_path=root / "micro.npz", **KW)
    port.focus_threshold = 0.0
    from pharmaconet_tpu.api import get_pmnet_dev as jax_get_pmnet_dev

    jax_net = jax_get_pmnet_dev(weight_path=root / "micro.npz", **KW)
    jax_net.focus_threshold = 0.0
    return SimpleNamespace(root=root, codes=codes, centers=centers, port=port, jax_net=jax_net,
                           protein_dir=protein_dir)


def micro_config(setup, log_dir: str, cls=Config):
    """tests/test_training.py's micro trainer settings."""
    config = cls()
    config.log_dir = str(setup.root / log_dir)
    config.data.protein_info_path = str(setup.root / "protein_info.csv")
    config.data.train_protein_code_path = str(setup.root / "train_key.txt")
    config.data.protein_dir = str(setup.protein_dir)
    config.data.ligand_path = str(setup.root / "ligand.pkl")
    config.model.hidden_dim = 16
    config.model.ligand_num_convs = 2
    config.train.max_iterations = 3
    config.train.batch_size = 2
    config.train.split_ratio = 0.5
    config.train.val_every = 2
    config.train.save_every = 2
    config.train.log_every = 1
    config.train.print_every = 10
    config.train.center_noise = 0.0
    return config


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return micro_setup(tmp_path_factory.mktemp("training"))


@pytest.fixture(scope="module")
def jax_trainer(setup):
    from pharmaconet_tpu.training.trainer import Trainer as JaxTrainer

    return JaxTrainer(micro_config(setup, "jax_log", JaxConfig), pmnet=setup.jax_net)


def port_trainer(setup, log_dir: str, jax_trainer=None, **kw) -> Trainer:
    """A port trainer on the CPU, with the JAX trainer's parameters when
    given."""
    trainer = Trainer(micro_config(setup, log_dir), pmnet=setup.port, device="cpu", **kw)
    if jax_trainer is not None:
        trainer.model.load_state_dict(convert.state_dict_from_flax(
            trainer.model, jax.tree.map(np.array, jax_trainer.params)))
    return trainer


def _numpy_state(trainer) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in trainer.params.items()}


# --------------------------------------------------------------------------
def test_config_yaml_both_ways(tmp_path):
    config = Config()
    config.log_dir = "x"
    config.train.batch_size = 7
    config.model.hidden_dim = 42
    config.train.opt.betas = (0.8, 0.99)
    config.save(tmp_path / "port.yaml")
    loaded = JaxConfig.load(tmp_path / "port.yaml")
    assert loaded.to_dict() == {**config.to_dict(), "train": {**config.to_dict()["train"], "opt": {
        **config.to_dict()["train"]["opt"], "betas": [0.8, 0.99]}}}
    jax_config = JaxConfig()
    jax_config.log_dir = "y"
    jax_config.train.lr_scheduler.lr_decay = 123
    jax_config.data.ligand_path = "lig.pkl"
    jax_config.save(tmp_path / "jax.yaml")
    back = Config.load(tmp_path / "jax.yaml")
    assert back.train.lr_scheduler.lr_decay == 123 and back.data.ligand_path == "lig.pkl"
    assert Config.load(tmp_path / "port.yaml").to_dict() == loaded.to_dict()
    assert back.to_dict() == JaxConfig.load(tmp_path / "jax.yaml").to_dict()


def test_pocket_items_equal_jax(setup):
    """Each padded array of a PocketItem equals the JAX dataset's on the
    same pocket (center_noise 0); the pyramid stays a list of tensors."""
    args = ([*setup.codes], {c: tuple(v) for c, v in setup.centers.items()}, setup.protein_dir,
            setup.root / "ligand.pkl")
    mine = dataset.PocketLigandDataset(*args, setup.port)
    theirs = jdataset.PocketLigandDataset(*args, setup.jax_net)
    shapes = set()
    for i in range(len(setup.codes)):
        a, b = mine[i], theirs[i]
        assert all(isinstance(f, torch.Tensor) for f in a.multi_scale_features)
        for f, g in zip(a.multi_scale_features, b.multi_scale_features, strict=True):
            np.testing.assert_allclose(f.numpy(), np.asarray(g), **FEATURE_TOL)
        np.testing.assert_allclose(a.hotspot_features, b.hotspot_features, **FEATURE_TOL)
        for name in ("hotspot_positions", "hotspot_valid", "affinities", "ligand_valid"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.batch_arrays[-1] == b.batch_arrays[-1]
        for x, y in zip(a.batch_arrays[:-1], b.batch_arrays[:-1], strict=True):
            np.testing.assert_array_equal(x, np.asarray(y))
        assert a.hotspot_valid.any()  # the open gates kept hotspots
        shapes.add((a.hotspot_features.shape[0], a.batch_arrays[-1]))
    assert len(mine.timings) == 4 and len(shapes) > 1


def test_repad_items_equal_jax(setup):
    args = ([*setup.codes], {c: tuple(v) for c, v in setup.centers.items()}, setup.protein_dir,
            setup.root / "ligand.pkl")
    mine = dataset.PocketLigandDataset(*args, setup.port)
    theirs = jdataset.PocketLigandDataset(*args, setup.jax_net)
    got = dataset.repad_items([mine[i] for i in (0, 3)])
    want = jdataset.repad_items([theirs[i] for i in (0, 3)])
    for a, b in zip(got, want, strict=True):
        for name in ("hotspot_positions", "hotspot_valid", "affinities", "ligand_valid"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        np.testing.assert_allclose(a.hotspot_features, b.hotspot_features, **FEATURE_TOL)
        assert a.batch_arrays[-1] == b.batch_arrays[-1]
        for x, y in zip(a.batch_arrays[:-1], b.batch_arrays[:-1], strict=True):
            np.testing.assert_array_equal(x, np.asarray(y))


def _unpadded(item):
    """A PocketItem (of either package) without its padded hotspot rows."""
    k = int(item.hotspot_valid.sum())
    return dataclasses.replace(item, hotspot_features=item.hotspot_features[:k],
                               hotspot_positions=item.hotspot_positions[:k],
                               hotspot_valid=item.hotspot_valid[:k])


def test_affinity_model_matches_flax(setup):
    """DevAffinityModel's forward and loss against flax apply on carried
    random leaves (biases nonzero), on a pocket's real hotspot rows. With
    its padded rows the port predicts the same (exact masking); the JAX
    model does not: its head sums the padded hotspot columns, whose pair
    energy fc2(leaky(fc1(leaky(b)))) is nonzero once the biases are (ROADMAP
    Queue 3)."""
    args = ([setup.codes[2]], {c: tuple(v) for c, v in setup.centers.items()},
            setup.protein_dir, setup.root / "ligand.pkl")
    item = dataset.PocketLigandDataset(*args, setup.port)[0]
    jitem = jdataset.PocketLigandDataset(*args, setup.jax_net)[0]
    assert not item.hotspot_valid.all()  # padded hotspot rows to mask
    flax_model = JaxDevAffinityModel(hidden_dim=16, ligand_num_convs=2)
    params = _init(flax_model, *jitem.model_args(), seed=1)
    model = DevAffinityModel(16, 2, token_dim=16, feature_dim=8, num_scales=3)
    model.load_state_dict(convert.state_dict_from_flax(model, params))
    real, jreal = _unpadded(item), _unpadded(jitem)
    with torch.no_grad():
        pred = model(*real.model_args("cpu"))
        loss = model.loss(*real.loss_args("cpu"))
        padded = model(*item.model_args("cpu"))
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.asarray(flax_model.apply(jparams, *jreal.model_args()))
    np.testing.assert_allclose(pred.numpy(), want, **TOL)
    np.testing.assert_allclose(float(loss), float(flax_model.apply(
        jparams, *jreal.loss_args(), method="loss")), **TOL)
    np.testing.assert_allclose(padded.numpy(), pred.numpy(), rtol=1e-6, atol=1e-6)
    jax_padded = np.asarray(flax_model.apply(jparams, *jitem.model_args()))
    n = int(item.ligand_valid.sum())
    assert np.abs(jax_padded - want)[:n].min() > 1e-3  # the JAX fault, on every ligand
    # junk in a padded row changes nothing
    junk = list(item.model_args("cpu"))
    junk[1] = junk[1].clone()
    junk[1][~junk[4]] = 7.0
    with torch.no_grad():
        np.testing.assert_array_equal(model(*junk).numpy(), padded.numpy())


def test_checkpoints_cross_packages(setup, jax_trainer, tmp_path):
    """The port's .npz loads into the flax DevAffinityModel and predicts the
    same, and the JAX trainer's .npz loads into the port."""
    trainer = port_trainer(setup, "npz_log")
    item = trainer.train_dataset[0]
    jitem = jax_trainer.train_dataset[0]
    trainer.save_checkpoint("last.npz")
    params, _ = jax_load_npz(trainer.save_dir / "last.npz")
    with torch.no_grad():
        pred = trainer.model(*item.model_args("cpu")).numpy()
    np.testing.assert_allclose(np.asarray(jax_trainer.model.apply(
        jax.tree.map(jnp.asarray, params), *jitem.model_args())), pred, **TOL)
    jax_trainer.save_checkpoint("jax_last.npz")
    model = copy.deepcopy(trainer.model)
    model.load_state_dict(convert.load_checkpoint(jax_trainer.save_dir / "jax_last.npz", model))
    with torch.no_grad():
        got = model(*item.model_args("cpu")).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_trainer.model.apply(
        jax_trainer.params, *jitem.model_args())), **TOL)
    # the round trip through the port's own .npz is exact
    model.load_state_dict(convert.load_checkpoint(trainer.save_dir / "last.npz", model))
    for k, v in model.state_dict().items():
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    trainer.close()


def test_trainer_step_matches_jax(setup, jax_trainer):
    """One step in three parts: (1) the loss and every gradient leaf;
    (2) the optimizer alone on identical gradients, clipped and not;
    (3) the parameters after 3 steps of both trainers. The items keep
    their real hotspot rows only, where both packages compute one function
    (the JAX head sums padded columns: `test_affinity_model_matches_flax`).

    Part 3's tolerance, 1e-6 absolute: Adam divides each gradient entry by
    its own running magnitude, so an entry that is 1e-12 on one side and
    exact 0 on the other could move its parameter by up to lr = 1e-3 a
    step; on these inputs no entry is that degenerate and 3 steps land
    3.0e-8 apart on the CPU. AdamW's decay of 0.05 (the config's
    `weight_decay`, which the JAX chain ignores) would move them by about
    5e-5 * |param| a step."""
    trainer = port_trainer(setup, "step_log", jax_trainer)
    items = [_unpadded(trainer.train_dataset[i]) for i in range(2)]
    jitems = [_unpadded(jax_trainer.train_dataset[i]).loss_args() for i in range(2)]
    params0 = jax_trainer.params

    # (1) loss and gradients
    def jax_loss(p):
        return jnp.mean(jnp.stack([jax_trainer.model.apply(p, *a, method="loss")
                                   for a in jitems]))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params0)
    loss, grads = trainer._loss_and_grads(items)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = convert.state_dict_from_flax(trainer.model, jax.tree.map(np.array, want_grads))
    for k, w in want.items():
        g = torch.zeros_like(w) if grads[k] is None else grads[k]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale + 1e-12, k
    # the loss reaches neither the pocket vector (3 convolutions, 2 linears)
    # nor the graph readout (2 linears)
    assert sum(g is None for g in grads.values()) == 14

    # (2) the optimizer alone on identical gradients (numpy, in the flax layout)
    rng = np.random.default_rng(0)
    opt = Optimizer(trainer.optimizer.schedule, clip=1.0)
    state = opt.init(trainer.params)
    jstate = jax_trainer.optimizer.init(params0)
    for scale in (1e-3, 10.0, 1e-3):  # under the clip, over it, under it
        g_tree = jax.tree.map(lambda x: rng.normal(0, scale, x.shape).astype(np.float32),
                              jax.tree.map(np.array, params0))
        jup, jstate = jax_trainer.optimizer.update(jax.tree.map(jnp.asarray, g_tree), jstate,
                                                   params0)
        up, state = opt.update(convert.state_dict_from_flax(trainer.model, g_tree), state)
        want_up = convert.state_dict_from_flax(trainer.model, jax.tree.map(np.array, jup))
        for k, w in want_up.items():
            assert float((up[k] - w).abs().max()) <= 1e-6 * float(w.abs().max()), k

    # (3) three steps of both trainers
    jp, jo = params0, jax_trainer.opt_state
    for _ in range(3):
        jp, jo, jl = jax_trainer._train_step(jp, jo, jitems)
        pl = trainer._train_step(items)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    want = convert.state_dict_from_flax(trainer.model, jax.tree.map(np.array, jp))
    worst = max(float((trainer.params[k].detach() - w).abs().max()) for k, w in want.items())
    assert worst <= 1e-6, worst
    assert trainer.opt_state["count"] == 3
    trainer.close()


def test_dp_step_matches_single_device(setup):
    single = port_trainer(setup, "dp_single")
    dp = port_trainer(setup, "dp_mesh", mesh=[torch.device("cpu")] * 2)
    dp.model.load_state_dict(single.model.state_dict())
    items = [single.train_dataset[i % 2] for i in range(4)]
    loss_single = single._train_step(items)
    loss_dp = dp.dp_step(items)
    np.testing.assert_allclose(float(loss_dp), float(loss_single), rtol=1e-5)
    for k, p in single.params.items():
        np.testing.assert_allclose(dp.params[k].detach().numpy(), p.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="must divide"):
        dp.dp_step(items[:3])
    single.close()
    dp.close()


def test_fit_writes_checkpoints_and_metrics(setup):
    trainer = port_trainer(setup, "fit_log")
    assert len(trainer.train_dataset) == 2 and len(trainer.val_dataset) == 2
    trainer.fit()
    for name in ("best.npz", "last.npz", "resume.ckpt", "epoch-1-it-2.npz"):
        assert (trainer.save_dir / name).exists(), name
    assert (trainer.log_dir / "config.yaml").exists() and (trainer.log_dir / "train.log").exists()
    records = [json.loads(x) for x in (trainer.log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2, 3]
    assert [r["step"] for r in records if "valid/loss" in r] == [2]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k.endswith("loss"))
    assert trainer.opt_state["count"] == 3
    # 3 train batches of 2 and one validation over 2 pockets, K6's plain
    # twin once per item: one trunk run per item fetched
    assert len(trainer.train_dataset.timings) == 6 and len(trainer.val_dataset.timings) == 2
    # a resumed fit continues after the saved iteration: one more step
    resumed = port_trainer(setup, "fit_log")
    resumed.fit(resume_from=trainer.save_dir / "resume.ckpt")
    assert resumed.opt_state["count"] == 3
    trainer.close()
    resumed.close()


def test_resume_then_one_step_equals_uninterrupted(setup):
    trainer = port_trainer(setup, "resume_log")
    items = [trainer.train_dataset[i] for i in range(2)]
    trainer._train_step(items)
    trainer.save_state("resume.ckpt", 1, 0)
    trainer._train_step(items[::-1])
    again = port_trainer(setup, "resume_log")
    assert again.restore_state(trainer.save_dir / "resume.ckpt") == (1, 0)
    again._train_step(items[::-1])
    want = _numpy_state(trainer)
    for k, v in _numpy_state(again).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k in ("mu", "nu"):
        for name, t in again.opt_state[k].items():
            assert torch.equal(t, trainer.opt_state[k][name]), name
    trainer.close()
    again.close()


def test_async_backend_saves_and_restores(setup):
    """backend='orbax' (a JAX config's name for the asynchronous save)
    writes the same state off the loop; it restores and steps."""
    trainer = port_trainer(setup, "async_log")
    items = [trainer.train_dataset[0]]
    trainer._train_step(items)
    trainer.save_state("async.ckpt", it=5, epoch=1, backend="orbax")
    trainer._train_step(items)  # the snapshot was taken before this step
    trainer.wait_for_checkpoints()
    trainer.save_state("sync.ckpt", it=5, epoch=1)
    other = port_trainer(setup, "async_log")
    assert other.restore_state(trainer.save_dir / "async.ckpt") == (5, 1)
    assert other.opt_state["count"] == 1
    with open(trainer.save_dir / "sync.ckpt", "rb") as f:
        later = pickle.load(f)
    assert later["opt_state"]["count"] == 2
    other._train_step(items)
    for k, v in _numpy_state(other).items():
        np.testing.assert_array_equal(v, later["params"][k], err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        trainer.save_state("x.ckpt", 1, 0, backend="zarr")
    trainer.close()
    other.close()


def test_overfits_one_batch(setup):
    trainer = port_trainer(setup, "overfit_log")
    items = [trainer.train_dataset[0]]
    losses = [float(trainer._train_step(items)) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    trainer.close()


def test_trainer_needs_a_card_for_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(micro_config(setup, "cuda_log"))  # default device, default pmnet


def test_gine_and_segment_sum_gradcheck():
    """float64 gradcheck of the GINE encoder (the `index_add_` aggregation
    at edge_dst, the gather x[edge_src]) and of the sorted segment-sum
    readout on a small graph batch, on the CPU (tests/test_torch_training_card.py
    runs it on CUDA)."""
    batch = batch_graphs(smi2graph_list(["CCO", "c1ccncc1", "CC(=O)O"]), num_graphs_pad=4)
    arrays = graph_batch_to_arrays(batch, categorical=False)
    torch.manual_seed(0)
    encoder = gnn.GraphEncoder(hidden_dim=4, out_dim=3, num_convs=2, categorical=False).double()
    atom_in = arrays[0].double().requires_grad_()
    edge_in = arrays[5].double().requires_grad_()

    def run(a, e):
        x, z = encoder((a, *arrays[1:5], e, *arrays[6:]))
        return x.sum(-1), z

    assert torch.autograd.gradcheck(run, (atom_in, edge_in))
    x = torch.randn(len(arrays[1]), 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: gnn.sorted_segment_sum(t, arrays[1], arrays[7]), (x,))
