"""Training step of the PharmacoNet detector, and the optimizer both trainers
use (torch).

`pharmaconet_tpu/training/train_step.py`: BCE losses on the cavity heads,
the token scores and the per-hotspot segmentation masks, optimized by
global-norm clipping, Adam and an exponential decay; data parallel over a
device list (one replica per device on its share of the batch, gradients
averaged onto the first device before the update).

Every tensor of the flax tree is a trained leaf there, the frozen
BatchNorm statistics included (`network/layers.py` `FrozenBatchNorm`
holds them as params). `all_tensors_trainable` makes the torch modules
match: every persistent buffer becomes a parameter under its own name, so
`named_parameters()` lists the state dict and `load_state_dict` is
unchanged.

The optimizer is optax's chain formula for formula, in float32:
`clip_by_global_norm` (no epsilon in the norm, unlike
`torch.nn.utils.clip_grad_norm_`), `scale_by_adam` (eps outside the square
root, bias correction by the step count), then the update scaled by
-schedule(count) from count 0. It applies no weight decay, as the JAX
chain does not.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..module import precision_scope
from ..parallel.mesh import average_onto, module_replicas, sync_replicas


def all_tensors_trainable(module: nn.Module) -> nn.Module:
    """Turn every persistent buffer of `module` into a parameter (in place)."""
    for sub in module.modules():
        for name in [n for n, b in sub._buffers.items()
                     if b is not None and n not in sub._non_persistent_buffers_set]:
            sub.register_parameter(name, nn.Parameter(sub._buffers.pop(name)))
    return module


def exponential_decay(lr: float, decay_steps: int, rate: float) -> Callable[[int], np.float32]:
    """optax.exponential_decay(lr, decay_steps, rate) (no staircase), in
    float32: lr * rate ** (count / decay_steps)."""
    def schedule(count: int) -> np.float32:
        if count <= 0:
            return np.float32(lr)
        return np.float32(lr) * np.power(np.float32(rate),
                                         np.float32(count) / np.float32(decay_steps))
    return schedule


class Optimizer:
    """clip_by_global_norm(clip) -> scale_by_adam(b1, b2, eps) -> scale by
    -schedule(count). Functional, as optax: `init(params)` gives the state,
    `update(grads, state)` the updates and the next state; a gradient of
    None (a tensor the loss does not reach) counts as zeros."""

    def __init__(self, schedule: Callable[[int], Any], clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.clip, self.b1, self.b2, self.eps = schedule, clip, b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        zeros = {k: torch.zeros_like(p, memory_format=torch.contiguous_format).detach()
                 for k, p in params.items()}
        return {"count": 0, "mu": zeros, "nu": {k: v.clone() for k, v in zeros.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict) -> tuple[dict[str, torch.Tensor], dict]:
        grads = {k: grads[k] if grads.get(k) is not None else torch.zeros_like(m)
                 for k, m in state["mu"].items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if not bool(norm < self.clip):
            grads = {k: (g / norm) * self.clip for k, g in grads.items()}
        count = state["count"] + 1
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        c1 = float(np.float32(1) - b1 ** np.float32(count))
        c2 = float(np.float32(1) - b2 ** np.float32(count))
        step = -float(np.float32(self.schedule(state["count"])))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            updates[k] = step * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps))
        return updates, {"count": count, "mu": mu, "nu": nu}


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], updates: dict[str, torch.Tensor]) -> None:
    for k, p in params.items():
        p.add_(updates[k])


def make_optimizer(lr: float = 1e-3, decay_rate: float = 0.99, decay_steps: int = 1000,
                   clip: float = 1.0) -> Optimizer:
    """Adam + exponential decay + clip (developer/src/trainer.py:165-175),
    as the JAX package's `optax.chain(clip_by_global_norm(clip),
    adam(exponential_decay(lr, decay_steps, decay_rate)))`."""
    return Optimizer(exponential_decay(lr, decay_steps, decay_rate), clip)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, averaged: over `mask` (the sum of
    loss * mask, broadcast, over the sum of `mask` as given, at least 1) or
    over every element."""
    loss = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    if mask is not None:
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def detector_loss(model: nn.Module, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    """batch (tensors on the model's device):
    image        [B, D, H, W, 33]
    tokens       [B, T, 4]
    token_mask   [B, T]        (1 = real token)
    token_label  [B, T]        (binary hotspot label)
    cavity_short [B, D, H, W]
    cavity_long  [B, D, H, W]
    mask_label   [B, T, D, H, W] (binary density label per token)

    The segmentation term divides by the number of valid tokens, as the
    JAX package's `bce_with_logits(seg, label, token_mask[:, None, None,
    None])` does: the mask's sum is taken before it broadcasts over D*H*W.
    The per-sample loop replaces `jax.vmap`."""
    pyramid = model.forward_feature(batch["image"])
    narrow, wide = model.forward_cavity_extraction(pyramid[-1])
    cavity = (bce_with_logits(narrow[..., 0], batch["cavity_short"])
              + bce_with_logits(wide[..., 0], batch["cavity_long"]))
    token_losses, seg_losses = [], []
    for b in range(batch["image"].shape[0]):
        tokens, mask = batch["tokens"][b], batch["token_mask"][b]
        scores, token_feats = model.forward_token_prediction(pyramid[-1][b:b + 1], tokens)
        token_losses.append(bce_with_logits(scores, batch["token_label"][b], mask))
        seg = model.forward_segmentation([p[b:b + 1] for p in pyramid], tokens, token_feats)
        seg_losses.append(bce_with_logits(seg, batch["mask_label"][b],
                                          mask[:, None, None, None]))
    return cavity + torch.stack(token_losses).mean() + torch.stack(seg_losses).mean()


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    mesh: list[torch.device] | None = None) -> Callable:
    """step(batch) -> loss: one optimizer step of `model` (made trainable in
    every tensor, on its device) on a batch of numpy arrays or tensors
    (`make_dummy_batch`'s keys), in full f32 (TF32 off). With a mesh of
    several devices (its first the model's), each device runs a replica on
    a contiguous share of the batch (the batch size a multiple of the mesh
    size) and the shares' losses and gradients are averaged onto the first
    device before the update. The optimizer state lives in the closure
    (`step.state`)."""
    all_tensors_trainable(model)
    params = dict(model.named_parameters())
    state = optimizer.init(params)
    replicas = module_replicas(model, mesh)

    def loss_and_grads(replica, device, shard):
        with precision_scope("float32", device):
            batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                        else v).to(device) for k, v in shard.items()}
            rep_params = dict(replica.named_parameters())
            loss = detector_loss(replica, batch)
            grads = torch.autograd.grad(loss, list(rep_params.values()), allow_unused=True)
        return loss.detach(), dict(zip(rep_params, grads))

    def step(batch: dict) -> torch.Tensor:
        n = len(replicas)
        size = next(iter(batch.values())).shape[0]
        if size % n:
            raise ValueError(f"mesh size {n} must divide the batch size {size}")
        share = size // n
        sync_replicas(replicas, params)
        results = [loss_and_grads(rep, dev, {k: v[i * share:(i + 1) * share]
                                             for k, v in batch.items()})
                   for i, (rep, dev) in enumerate(replicas)]
        loss, grads = average_onto(results, params)
        updates, step.state = optimizer.update(grads, step.state)
        apply_updates(params, updates)
        return loss

    step.state = state
    return step


def make_dummy_batch(batch_size: int, grid: int, num_tokens: int, seed: int = 0
                     ) -> dict[str, Any]:
    """Tiny synthetic batch for smoke tests / multichip dryruns (numpy; the
    JAX package's draws)."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(0, 1, (batch_size, grid, grid, grid, 33)).astype("float32"),
        "tokens": (
            rng.integers(0, grid, (batch_size, num_tokens, 4))
            % np.array([grid, grid, grid, 10])
        ).astype("int32"),
        "token_mask": (rng.uniform(size=(batch_size, num_tokens)) > 0.2).astype("float32"),
        "token_label": rng.integers(0, 2, (batch_size, num_tokens)).astype("float32"),
        "cavity_short": rng.integers(0, 2, (batch_size, grid, grid, grid)).astype("float32"),
        "cavity_long": rng.integers(0, 2, (batch_size, grid, grid, grid)).astype("float32"),
        "mask_label": rng.integers(0, 2, (batch_size, num_tokens, grid, grid, grid)).astype(
            "float32"
        ),
    }
