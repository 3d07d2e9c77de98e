"""Top-down FPN decoder (torch, NCDHW).

Lateral 1x1 conv stacks + nearest x2 upsampling + 3x3 conv stacks, all to
96 channels, emitted top-down (lowest resolution first), as the JAX
package's `network/fpn.py`. Used twice: the feature-embedding FPN over
(input, 4 backbone scales) and the mask head's private decoder over 5
conditioned 96-channel scales.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .layers import BaseConv3d, upsample_nearest_2x


class FPNDecoder(nn.Module):
    def __init__(self, feature_channels: Sequence[int] = (33, 96, 192, 384, 768),
                 num_convs: Sequence[int] = (1, 2, 2, 2, 2), channels: int = 96):
        super().__init__()
        n = len(feature_channels)
        self.lateral_conv_list = nn.ModuleList(
            BaseConv3d(feature_channels[level], channels, kernel_size=1) for level in range(n - 1)
        )
        self.fpn_convs_list = nn.ModuleList(
            nn.ModuleList(
                BaseConv3d(feature_channels[level] if level == n - 1 and j == 0 else channels,
                           channels, kernel_size=3)
                for j in range(num_convs[level])
            )
            for level in range(n)
        )

    def forward(self, features: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """features: bottom-up [highest-res, ..., lowest-res] NCDHW.
        Returns top-down [lowest-res, ..., highest-res]."""
        n = len(features)
        fpn = None
        outs = []
        for level in range(n - 1, -1, -1):
            if level == n - 1:
                fpn = features[level]  # top level: identity lateral
            else:
                fpn = self.lateral_conv_list[level](features[level]) + upsample_nearest_2x(fpn)
            for conv in self.fpn_convs_list[level]:
                fpn = conv(fpn)
            outs.append(fpn)
        return outs
