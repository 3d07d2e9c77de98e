"""Parameters of the affinity model across the two packages.

`DevAffinityModel`'s modules carry the docking proxies' module names, so
the proxies' rewrite rules (`proxy.convert.FLAX_RULES`) map its state dict
onto the JAX package's flax `DevAffinityModel` tree and back. The trainers'
checkpoints (`best.npz`, `last.npz`, `epoch-*-it-*.npz`) are the JAX
package's flat `.npz` of that tree under its top-level 'params' key
(`pharmaconet_tpu/network/convert.py:295-314`), so either trainer's load
in the other. flax's `PRNGKey(0)` init cannot be reproduced in torch: the
trainer draws its init from a `torch.Generator`
(`proxy.convert.random_state_dict`).
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ..network.convert import (
    flax_state_from_torch,
    load_npz_checkpoint,
    save_npz_checkpoint,
    torch_state_from_flax,
)
from ..proxy.convert import FLAX_RULES


def state_dict_from_flax(model: nn.Module, params: dict) -> dict[str, torch.Tensor]:
    """`model`'s state dict from a flax `DevAffinityModel` tree (numpy
    leaves, with or without the top-level 'params')."""
    return torch_state_from_flax(model, params.get("params", params), FLAX_RULES)


def save_checkpoint(path: str | Path, model: nn.Module) -> None:
    """`model`'s tensors as the JAX trainer's `.npz` checkpoint: the flax
    variables {'params': tree}, no score distributions."""
    save_npz_checkpoint(path, {"params": flax_state_from_torch(model, model.state_dict(),
                                                               FLAX_RULES)}, {})


def load_checkpoint(path: str | Path, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict for `model` from a trainer `.npz` of either package."""
    params, _ = load_npz_checkpoint(path)
    return state_dict_from_flax(model, params)

