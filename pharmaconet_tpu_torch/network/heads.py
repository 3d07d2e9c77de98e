"""Prediction heads: cavity extraction, token scoring, conditional masks.

Torch counterparts of the JAX package's `network/heads.py`. The mask head
segments a chunk of hotspots as one batch: every hotspot conditions the
whole 5-scale pyramid with its own background embedding, plus a point
embedding added at its own voxel only (no hotspot sees another's point).
"""

from __future__ import annotations

import torch
from torch import nn

from .fpn import FPNDecoder
from .layers import BaseConv3d


class CavityHead(nn.Module):
    """Two conv stacks predicting narrow/wide cavity logits."""

    def __init__(self, feature_dim: int = 96, hidden_dim: int = 96):
        super().__init__()
        self.short_head = nn.Sequential(
            BaseConv3d(feature_dim, hidden_dim, kernel_size=3),
            BaseConv3d(hidden_dim, 1, kernel_size=1, use_norm=False, use_act=False),
        )
        self.long_head = nn.Sequential(
            BaseConv3d(feature_dim, hidden_dim, kernel_size=3),
            BaseConv3d(hidden_dim, 1, kernel_size=1, use_norm=False, use_act=False),
        )

    def forward(self, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, F, D, H, W] -> (narrow, wide) logits, each [B, 1, D, H, W]."""
        return self.short_head(features), self.long_head(features)


class TokenHead(nn.Module):
    """Token feature extraction + scoring.

    token feature = skip(cat[voxel feature, type embedding])
                    + SiLU-MLP(cat[...]); score = ReLU-MLP -> scalar logit.
    The skip is a Linear only when 2 * feature_dim != token_feature_dim.
    """

    def __init__(self, feature_dim: int = 96, num_interactions: int = 10,
                 token_feature_dim: int = 192, num_feature_mlp_layers: int = 3,
                 num_score_mlp_layers: int = 3):
        super().__init__()
        self.interaction_embedding = nn.Embedding(num_interactions, feature_dim)
        layers: list[nn.Module] = []
        for i in range(num_feature_mlp_layers):
            layers += [nn.Linear(2 * feature_dim if i == 0 else token_feature_dim,
                                 token_feature_dim), nn.SiLU()]
        self.feature_mlp = nn.Sequential(*layers)
        layers = []
        for i in range(num_score_mlp_layers - 1):
            layers += [nn.Linear(token_feature_dim, token_feature_dim), nn.ReLU()]
        layers.append(nn.Linear(token_feature_dim, 1))
        self.score_mlp = nn.Sequential(*layers)
        self.skip = (nn.Linear(2 * feature_dim, token_feature_dim)
                     if 2 * feature_dim != token_feature_dim else None)

    def forward(self, features: torch.Tensor, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """features: [F, D, H, W]; tokens: [T, 4] int (x, y, z, type).
        Returns (scores [T], token_features [T, token_feature_dim]). Padded
        tokens produce rows the caller masks."""
        t = tokens.long()
        voxel_feats = features[:, t[:, 0], t[:, 1], t[:, 2]].T  # [T, F]
        concat = torch.cat([voxel_feats, self.interaction_embedding(t[:, 3])], dim=-1)
        skip = concat if self.skip is None else self.skip(concat)
        token_features = skip + self.feature_mlp(concat)
        return self.score_mlp(token_features)[:, 0], token_features


class MaskHead(nn.Module):
    """Per-hotspot conditional segmentation, batched over K hotspots."""

    def __init__(self, token_feature_dim: int = 192, channels: int = 96, num_levels: int = 5,
                 num_convs: tuple = (1, 2, 2, 2, 2)):
        super().__init__()
        self.background_mlp_list = nn.ModuleList(
            nn.Linear(token_feature_dim, channels) for _ in range(num_levels))
        self.point_mlp_list = nn.ModuleList(
            nn.Linear(token_feature_dim, channels) for _ in range(num_levels))
        self.decoder = FPNDecoder((channels,) * num_levels, num_convs, channels)
        self.conv_logits = nn.Conv3d(channels, 1, kernel_size=1)

    def forward(self, multi_scale_features: list[torch.Tensor], tokens: torch.Tensor,
                token_features: torch.Tensor) -> torch.Tensor:
        """multi_scale_features: top-down [[1, C, d, h, w] x levels];
        tokens [K, 4]; token_features [K, token_feature_dim].
        Returns [K, D, H, W] mask logits at full resolution."""
        bottom_up = multi_scale_features[::-1]  # highest-res first
        k = tokens.shape[0]
        full = bottom_up[0].shape[-1]
        t = tokens.long()
        hot = torch.arange(k, device=tokens.device)[:, None]
        conditioned = []
        for level, feats in enumerate(bottom_up):
            c, d = feats.shape[1], feats.shape[-1]
            scale = full // d
            background = self.background_mlp_list[level](token_features)  # [K, C]
            point = self.point_mlp_list[level](token_features)
            box = background[:, :, None, None, None].expand(k, c, d, d, d).contiguous()
            box.index_put_((hot, torch.arange(c, device=tokens.device)[None, :],
                            (t[:, 0] // scale)[:, None], (t[:, 1] // scale)[:, None],
                            (t[:, 2] // scale)[:, None]), point, accumulate=True)
            conditioned.append(box.add_(feats))  # feats + box, in place
        top_down = self.decoder(conditioned)
        return self.conv_logits(top_down[-1])[:, 0]
