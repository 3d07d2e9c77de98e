"""Shared network building blocks (torch, NCDHW inside the convolutions).

Numerical contract of the published checkpoint, as in the JAX package:
  * LayerNorm eps = 1e-5
  * GELU is the exact erf form
  * BatchNorm3d runs in inference mode with the checkpoint's running
    statistics, as x * inv + (bias - mean * inv), inv = scale / sqrt(var + eps)

Submodule and parameter names follow the upstream torch checkpoint
(`_conv`, `_norm`, `weight`, `running_mean`, ...), so its state dict loads
with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over the channel axis of NCDHW tensors."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * inv
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.view(view) + shift.view(view)


class BaseConv3d(nn.Module):
    """Conv3d + optional frozen BatchNorm + optional ReLU. The conv has a
    bias only when there is no norm."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_norm: bool = True, use_act: bool = True):
        super().__init__()
        self._conv = nn.Conv3d(in_features, features, kernel_size,
                               padding=(kernel_size - 1) // 2, bias=not use_norm)
        self._norm = FrozenBatchNorm(features) if use_norm else None
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv(x)
        if self._norm is not None:
            x = self._norm(x)
        if self.use_act:
            x = F.relu(x)
        return x


class Mlp(nn.Module):
    """fc1 -> GELU (exact) -> fc2."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-neighbour x2 upsampling of the spatial axes of NCDHW."""
    b, c, d, h, w = x.shape
    x = x[:, :, :, None, :, None, :, None].expand(b, c, d, 2, h, 2, w, 2)
    return x.reshape(b, c, d * 2, h * 2, w * 2)
