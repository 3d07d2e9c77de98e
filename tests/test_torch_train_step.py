"""The port's detector train step (`pharmaconet_tpu_torch.training.train_step`)
against the JAX package's, at `__graft_entry__.py`'s micro widths: grid 8,
embed 8, depths (1, 1), heads (1, 2), window 2, token features 16, on
`make_dummy_batch(2, 8, 4)`. The flax init (`PRNGKey(0)`, as the graft
entry draws it) is carried into the port with `network.convert`.

Tolerances, each with its reason:
  * the loss rtol 1e-5 and every gradient leaf within 1e-4 of that leaf's
    largest entry (f32 on both sides, in another summation order);
  * the optimizer alone on identical gradients: every update within 1e-6
    of its leaf's largest (the same float32 formulas; see
    `test_torch_training.py`);
  * the parameters after 3 steps: within 1e-5 absolute (the reason and
    the CPU's measurement in `test_three_steps_match_jax`);
  * a 2-device CPU mesh against one device: loss rtol 1e-5, parameters
    rtol 1e-4 / atol 1e-5, as `tests/test_training.py` holds the JAX DP
    step.
"""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu.training import train_step as jstep
from pharmaconet_tpu_torch.network.convert import state_dict_from_flax
from pharmaconet_tpu_torch.network.model import build_model
from pharmaconet_tpu_torch.training import train_step

MICRO = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID, TOKENS = 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    batch = train_step.make_dummy_batch(2, GRID, TOKENS)
    jmodel = jax_build_model(image_size=GRID, **MICRO)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch["image"][:1],
                                  jbatch["tokens"][0])
    return jmodel, params, batch, jbatch


def port_model(params) -> torch.nn.Module:
    model = build_model(image_size=GRID, **MICRO)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.array, params),
                                               model.config))
    return train_step.all_tensors_trainable(model)


def as_port(model, tree) -> dict[str, torch.Tensor]:
    """A flax tree (parameters, gradients or updates) in the port's names."""
    return state_dict_from_flax(jax.tree.map(np.array, tree), model.config)


def test_make_dummy_batch_equals_jax():
    got, want = train_step.make_dummy_batch(3, 6, 5, seed=2), jstep.make_dummy_batch(3, 6, 5, 2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bce_with_logits_and_the_segmentation_denominator():
    """optax's sigmoid BCE, averaged as the JAX package does; a [T,1,1,1]
    mask divides by its own sum (the valid tokens), not by the T*D*H*W
    elements it broadcasts over (ROADMAP Queue 3, an observation)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 3, 3, 3)).astype(np.float32)
    labels = rng.integers(0, 2, logits.shape).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)[:, None, None, None]
    for m in (None, mask):
        got = train_step.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                         None if m is None else torch.from_numpy(m))
        want = jstep.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_element = -labels * np.log(1 / (1 + np.exp(-logits))) - (1 - labels) * np.log(
        1 / (1 + np.exp(logits)))
    masked = train_step.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(float(masked), (per_element * mask).sum() / 3, rtol=1e-5)


def test_loss_and_gradients_match_jax(case):
    jmodel, params, batch, jbatch = case
    model = port_model(params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    named = dict(model.named_parameters())
    loss = train_step.detector_loss(model, tensors)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    loss = loss.detach()
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        functools.partial(jstep.detector_loss, jmodel)))(params, jbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = as_port(model, want_grads)
    assert want.keys() == named.keys()  # every flax leaf is trained, BN statistics included
    for (k, g) in zip(named, grads):
        w = want[k]
        g = torch.zeros_like(w) if g is None else g
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-12, k
    assert any("running_var" in k for k in named)


def test_optimizer_matches_optax(case):
    _, params, _, _ = case
    model = port_model(params)
    named = dict(model.named_parameters())
    opt, jopt = train_step.make_optimizer(), jstep.make_optimizer()
    state, jstate = opt.init(named), jopt.init(params)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(1)
    for scale in (1e-3, 10.0, 1e-3):  # under the clip, over it, under it
        g_tree = jax.tree.map(lambda x: rng.normal(0, scale, x.shape).astype(np.float32),
                              jax.tree.map(np.array, params))
        jup, jstate = jupdate(jax.tree.map(jnp.asarray, g_tree), jstate, params)
        up, state = opt.update(as_port(model, g_tree), state)
        for k, w in as_port(model, jup).items():
            assert float((up[k] - w).abs().max()) <= 1e-6 * float(w.abs().max()), k


def test_three_steps_match_jax(case):
    """Three optimizer steps of both packages' train steps. The parameters
    land 1.7e-6 apart on the CPU. Adam normalises each gradient entry by
    its own magnitude, so an entry that is small against its leaf's
    largest keeps a relative error up to 1e-3 (part 1 holds a leaf to 1e-4
    of its largest), which a step turns into lr * 1e-3 = 1e-6; 1e-5 holds
    3 steps to that."""
    jmodel, params, batch, jbatch = case
    model = port_model(params)
    step = train_step.make_train_step(model, train_step.make_optimizer())
    jopt = jstep.make_optimizer()
    jtrain = jstep.make_train_step(jmodel, jopt)
    jp, jo = params, jopt.init(params)
    for _ in range(3):
        jp, jo, jl = jtrain(jp, jo, jbatch)
        np.testing.assert_allclose(float(step(batch)), float(jl), rtol=1e-5)
    assert step.state["count"] == 3
    named = dict(model.named_parameters())
    worst = max(float((named[k].detach() - w).abs().max()) for k, w in as_port(model, jp).items())
    assert worst <= 1e-5, worst


def test_two_device_mesh_equals_one(case):
    _, params, batch, _ = case
    single = port_model(params)
    meshed = copy.deepcopy(single)
    one = train_step.make_train_step(single, train_step.make_optimizer())
    two = train_step.make_train_step(meshed, train_step.make_optimizer(),
                                     mesh=[torch.device("cpu")] * 2)
    for _ in range(2):
        np.testing.assert_allclose(float(two(batch)), float(one(batch)), rtol=1e-5)
    for (k, a), (_, b) in zip(single.named_parameters(), meshed.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    three = train_step.make_train_step(copy.deepcopy(single), train_step.make_optimizer(),
                                       mesh=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="must divide"):
        three(batch)
