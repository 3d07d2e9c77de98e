"""Parameters of the docking proxies: upstream `.pth` state dicts, the JAX
package's flax trees, and random draws.

The port's proxy modules carry upstream's module names, so an upstream
state dict loads with `load_state_dict(strict=True)` once the tensors the
network does not use are left out (`state_dict_from_upstream`). The JAX
package keeps the same tensors as a flax tree; `FLAX_RULES` rewrite a
module path of the port into the flax one (the inverse of
`pharmaconet_tpu.proxy.{tacogfn,sbddreward}.convert_*_checkpoint`) and
`network.convert.torch_state_from_flax` applies the layout rules of each
tensor (Linear and Conv3d kernels transposed, LayerNorm weight <-> scale,
Embedding weight <-> embedding, GINE's eps by name).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..network.convert import torch_state_from_flax

FLAX_RULES = (
    (r"(^|\.)nn\.0$", r"\1nn_dense"),
    (r"conv_list\.(\d+)", r"conv_\1"),
    (r"(^|\.)head\.0$", r"\1head_dense"),
    (r"(^|\.)head\.1$", r"\1head_norm"),
    (r"pocket_mlp_list\.(\d+)\.1", r"pocket_conv_\1"),
    (r"(token_mlp|pocket_mlp|hotspot_mlp)\.1$", r"\1"),
    (r"(concat_gate|pair_energy_gate|linear_[bzo]_g)\.0$", r"\1"),
    (r"energy_bias_mlp\.(\d)", lambda m: f"energy_bias_fc{int(m[1]) // 2 + 1}"),
    (r"interaction_mlp\.0", "interaction_fc"),
    (r"pocket_layer\.(\d)", lambda m: f"pocket_fc{(int(m[1]) + 1) // 2}"),
    (r"mlp_(mu|std)\.(\d)", lambda m: f"{m[1]}_fc{int(m[2]) // 2 + 1}"),
    (r"mlp_sigma_bias\.(\d)", lambda m: f"sigma_bias_fc{int(m[1]) // 2 + 1}"),
    (r"mlp_sigma$", "sigma_fc"),
    (r"gate_sigma\.0", "sigma_gate"),
    (r"blocks\.(\d+)", r"block_\1"),
    (r"(^|\.)mha\.", r"\1"),
)


def state_dict_from_flax(module: nn.Module, params: dict) -> dict[str, torch.Tensor]:
    """`module`'s state dict from the JAX package's parameter tree of the
    same proxy module (numpy leaves, with or without the top 'params')."""
    return torch_state_from_flax(module, params.get("params", params), FLAX_RULES)


def state_dict_from_upstream(module: nn.Module, state: dict) -> dict[str, torch.Tensor]:
    """`module`'s state dict from an upstream checkpoint's (numpy arrays or
    tensors). Tensors the module does not hold (upstream's
    `head.linear_distance`, unused at inference) are left out; a missing
    one raises, and a shape that differs raises unless only its size-1
    axes differ (GINE's eps)."""
    out: dict[str, torch.Tensor] = {}
    for key, want in module.state_dict().items():
        if key not in state:
            raise KeyError(f"upstream checkpoint lacks {key}")
        value = torch.as_tensor(np.asarray(state[key], dtype=np.float32))
        if tuple(value.shape) != tuple(want.shape):
            if value.numel() != want.numel() or want.numel() != 1:
                raise ValueError(f"{key}: shape {tuple(value.shape)} does not fit "
                                 f"{tuple(want.shape)}")
            value = value.reshape(want.shape)
        out[key] = value
    return out


def random_state_dict(module: nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Reproducible random parameters from one `torch.Generator(seed)`,
    drawn in state-dict order: weights of Linear and Conv3d ~ N(0, 1/fan_in),
    embeddings ~ N(0, 1), LayerNorm weights 1, biases and eps 0."""
    gen = torch.Generator().manual_seed(seed)
    kinds = {}
    for mname, sub in module.named_modules():
        for pname, _ in [*sub.named_parameters(recurse=False), *sub.named_buffers(recurse=False)]:
            kinds[f"{mname}.{pname}" if mname else pname] = (type(sub), pname)
    out: dict[str, torch.Tensor] = {}
    for key, value in module.state_dict().items():
        kind, pname = kinds[key]
        if pname != "weight":
            out[key] = torch.zeros(value.shape)
        elif kind is nn.LayerNorm:
            out[key] = torch.ones(value.shape)
        else:
            fan_in = 1 if kind is nn.Embedding else int(np.prod(value.shape[1:]))
            out[key] = torch.randn(value.shape, generator=gen) * fan_in**-0.5
    return out
