"""Serving at scale and training on the card (skipped without one): the
sharded proxy scorer and cache builder on a one-card mesh against the
single-device proxy, the affinity-head trainer's step and the detector's
train step on the card against the CPU from the same parameters and
inputs, and float64 gradchecks of the GINE encoder and the segment sum on
CUDA. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_training_card.py

Tolerances: scores and caches at the repo tolerance (rtol 2e-5, atol 1e-4)
of the single-device proxy's. One step on the card against the CPU (full
f32 on both, TF32 off; the card sums in another order, and its
`index_add_` and the GINE gather's backward add with atomics, so no step
is bit-equal): the loss rtol 1e-5, every gradient leaf within 1e-4 of its
largest entry, and after the update the parameters within 1e-6 where the
gradient is settled (at least 1e-3 of its leaf's largest and 1e-6). Adam's
first step moves every entry by lr * g / (|g| + eps), about lr whatever
|g|, so an entry whose gradient is rounding noise may move either way; it
is not held (`chip_smoke.py` phase 11 holds its steps the same way). The
gradchecks allow nondeterminism of 1e-10 (float64 atomics).
"""

from __future__ import annotations

import copy
import pickle

import numpy as np
import pytest
import torch

from pharmaconet_tpu_torch.module import PharmacoNet, precision_scope
from pharmaconet_tpu_torch.network.model import build_model
from pharmaconet_tpu_torch.ops import voxelize_cuda
from pharmaconet_tpu_torch.parallel.proxy import ShardedCacheBuilder, ShardedProxyScorer
from pharmaconet_tpu_torch.proxy import gnn
from pharmaconet_tpu_torch.proxy.data import batch_graphs, smi2graph_list
from pharmaconet_tpu_torch.proxy.proxies import SBDDReward_Proxy, TacoGFN_Proxy
from pharmaconet_tpu_torch.proxy.tacogfn import graph_batch_to_arrays
from pharmaconet_tpu_torch.synthetic import write_synthetic_pocket
from pharmaconet_tpu_torch.training import Config, Trainer, train_step

pytestmark = pytest.mark.gpu
TOL = dict(rtol=2e-5, atol=1e-4)
MICRO = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window=2, token_feature_dim=16)
SMILES = ["c1ccccc1O", "CCO", "CC(=O)O", "c1ccncc1", "CCN(CC)CC", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
          "O=C(C)Oc1ccccc1C(=O)O"]


def assert_step_agrees(card: tuple, cpu: tuple) -> None:
    """card, cpu: (loss, {name: grad}, {name: parameter after the step})."""
    (loss_d, grads_d, params_d), (loss_h, grads_h, params_h) = card, cpu
    np.testing.assert_allclose(loss_d, loss_h, rtol=1e-5)
    for key, gh in grads_h.items():
        if gh is None:
            assert grads_d[key] is None, key
            continue
        scale = float(gh.abs().max())
        assert float((grads_d[key].cpu() - gh).abs().max()) <= 1e-4 * scale + 1e-30, key
        settled = gh.abs() >= max(1e-3 * scale, 1e-6)
        diff = (params_d[key].detach().cpu() - params_h[key].detach()).abs()
        assert not settled.any() or float(diff[settled].max()) <= 1e-6, key


def one_step(params: dict, loss_fn, optimizer) -> tuple:
    """(loss, gradients, params) of one update from fresh optimizer state."""
    loss = loss_fn()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))
    updates, _ = optimizer.update(grads, optimizer.init(params))
    train_step.apply_updates(params, updates)
    return float(loss.detach()), grads, params


@pytest.fixture(autouse=True)
def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_gradcheck_gine_and_segment_sum_on_cuda():
    batch = batch_graphs(smi2graph_list(["CCO", "c1ccncc1", "CC(=O)O"]), num_graphs_pad=4)
    arrays = graph_batch_to_arrays(batch, categorical=False, device="cuda")
    torch.manual_seed(0)
    encoder = gnn.GraphEncoder(hidden_dim=4, out_dim=3, num_convs=2,
                               categorical=False).double().cuda()
    atom_in = arrays[0].double().requires_grad_()
    edge_in = arrays[5].double().requires_grad_()

    def run(a, e):
        x, z = encoder((a, *arrays[1:5], e, *arrays[6:]))
        return x.sum(-1), z

    assert torch.autograd.gradcheck(run, (atom_in, edge_in), nondet_tol=1e-10)
    x = torch.randn(len(arrays[1]), 3, dtype=torch.float64, device="cuda", requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: gnn.sorted_segment_sum(t, arrays[1], arrays[7]),
                                    (x,), nondet_tol=1e-10)


@pytest.mark.parametrize("cls", [TacoGFN_Proxy, SBDDReward_Proxy], ids=["taco", "sbdd"])
def test_sharded_scorer_on_the_card(cls):
    proxy = cls(device="cuda")
    proxy._init_random(5)
    rng = np.random.default_rng(0)
    features = [rng.normal(0, 1, (1, d, d, d, 96)).astype(np.float32) for d in (4, 6, 8, 10, 12)]
    infos = [{"hotspot_feature": rng.normal(0, 1, 192).astype(np.float32),
              "hotspot_position": tuple(rng.uniform(-8, 8, 3).tolist())} for _ in range(6)]
    proxy.put_cache("t", proxy._get_cache(features, infos))
    smiles = [SMILES[i % len(SMILES)] for i in range(37)]
    sharded = ShardedProxyScorer(proxy)  # every visible card
    want = proxy.scoring_list("t", smiles)
    np.testing.assert_allclose(sharded.scoring_list("t", smiles), want, **TOL)
    chunks = list(sharded.scoring_iter("t", smiles, batch_size=16))
    assert [len(c) for c in chunks] == [16, 16, 5]
    np.testing.assert_allclose(np.concatenate(chunks), want, **TOL)


@pytest.fixture(scope="module")
def pockets(tmp_path_factory):
    """A micro PharmacoNet (random parameters, gates open) on the card and
    on the CPU, and the files of a 4-pocket training set (copies of one
    synthetic pocket at four centres)."""
    if not torch.cuda.is_available():  # module fixtures come before `needs_card`
        pytest.skip("needs a CUDA device")
    root = tmp_path_factory.mktemp("card_training")
    info = write_synthetic_pocket(root / "pocket.pdb", seed=0, cavity_radius=3.0,
                                  num_atoms=1200, outer_radius=20.0)
    (root / "proteins").mkdir()
    lines, ligands = [], {}
    for i in range(4):
        (root / "proteins" / f"p{i}.pdb").write_text((root / "pocket.pdb").read_text())
        center = [float(c) + 0.7 * i for c in info["center"]]
        lines.append(",".join([f"p{i}", *map(str, center)]))
        ligands[f"p{i}"] = [(f"l{j}", SMILES[(i + j) % len(SMILES)], -1.0 - j)
                            for j in range(3 + i)]
    (root / "info.csv").write_text("\n".join(lines))
    (root / "codes.txt").write_text("\n".join(f"p{i}" for i in range(4)))
    with open(root / "ligands.pkl", "wb") as f:
        pickle.dump(ligands, f)
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = PharmacoNet(score_threshold=0.0, verbose=False, grid_dim=16,
                                model_kwargs=MICRO, device=dev, _random_init_seed=3)
        nets[dev].focus_threshold = 0.0
    return root, nets, info


def _config(root, log_dir):
    config = Config()
    config.log_dir = str(root / log_dir)
    config.data.protein_info_path = str(root / "info.csv")
    config.data.train_protein_code_path = str(root / "codes.txt")
    config.data.protein_dir = str(root / "proteins")
    config.data.ligand_path = str(root / "ligands.pkl")
    config.model.hidden_dim = 16
    config.model.ligand_num_convs = 2
    config.train.batch_size = 2
    config.train.split_ratio = 0.5
    config.train.center_noise = 0.0
    return config


def test_trainer_step_card_vs_cpu(pockets):
    root, nets, _ = pockets
    card = Trainer(_config(root, "card"), pmnet=nets["cuda"], device="cuda")
    cpu = Trainer(_config(root, "cpu"), pmnet=nets["cpu"], device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    voxelize_cuda.reset_launch_counts()
    items = [card.train_dataset[i] for i in range(2)]
    assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == 2  # K6 once per item
    assert all(f.is_cuda for f in items[0].multi_scale_features)
    cpu_items = [cpu.train_dataset[i] for i in range(2)]
    steps = []
    for trainer, its in ((card, items), (cpu, cpu_items)):
        loss, grads = trainer._loss_and_grads(its)
        updates, _ = trainer.optimizer.update(grads, trainer.optimizer.init(trainer.params))
        train_step.apply_updates(trainer.params, updates)
        steps.append((float(loss), grads, trainer.params))
    assert_step_agrees(*steps)
    card.close()
    cpu.close()


def test_fit_on_the_card(pockets):
    root, nets, _ = pockets
    config = _config(root, "fit")
    config.train.max_iterations = 3
    config.train.val_every = config.train.save_every = 2
    trainer = Trainer(config, pmnet=nets["cuda"])  # the card by default
    voxelize_cuda.reset_launch_counts()
    trainer.fit()
    fetched = len(trainer.train_dataset.timings) + len(trainer.val_dataset.timings)
    assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == fetched == 8
    assert (trainer.save_dir / "last.npz").exists() and trainer.opt_state["count"] == 3
    trainer.close()


def test_sharded_cache_builder_on_the_card(pockets):
    root, nets, info = pockets
    proxy = SBDDReward_Proxy(device="cuda", model_kwargs=dict(token_dim=16, feature_dim=8,
                                                              num_scales=3))
    proxy._init_random(2)
    proxy.pmnet = nets["cuda"]
    pocket_info = {f"p{i}": (root / "proteins" / f"p{i}.pdb",
                             tuple(float(c) + 0.7 * i for c in info["center"])) for i in range(4)}
    pocket_info["bad"] = (root / "absent.pdb", info["center"])
    serial = proxy.get_cache_database(dict(pocket_info), verbose=False)
    voxelize_cuda.reset_launch_counts()
    sharded = ShardedCacheBuilder(proxy).get_cache_database(dict(pocket_info), verbose=False)
    assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == 4
    assert sorted(sharded) == sorted(serial) == [f"p{i}" for i in range(4)]
    for key in serial:
        for a, b in zip(sharded[key], serial[key], strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)


def test_detector_step_card_vs_cpu():
    batch = train_step.make_dummy_batch(2, 8, 4)
    torch.manual_seed(0)
    cpu_model = train_step.all_tensors_trainable(build_model(image_size=8, **MICRO))
    card_model = copy.deepcopy(cpu_model).cuda()
    steps = []
    for model, dev in ((card_model, "cuda"), (cpu_model, "cpu")):
        tensors = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with precision_scope("float32", torch.device(dev)):
            steps.append(one_step(dict(model.named_parameters()),
                                  lambda: train_step.detector_loss(model, tensors),
                                  train_step.make_optimizer()))
    assert_step_agrees(*steps)
    # the closure's step on the card runs too
    step = train_step.make_train_step(card_model, train_step.make_optimizer())
    assert np.isfinite(float(step(batch)))
