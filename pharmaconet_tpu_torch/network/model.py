"""PharmacoNet detector: embedding trunk + three heads (torch).

The module tree and its names follow the upstream torch checkpoint
(`embedding.backbone`, `embedding.decoder`, `cavity_head`, `token_head`,
`mask_head`), so its state dict loads strictly. The four forward passes
take and return the JAX package's channel-last layout ([B, D, H, W, C]);
the convolutions run in NCDHW inside, and the layout changes are views.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .fpn import FPNDecoder
from .heads import CavityHead, MaskHead, TokenHead
from .swin3d import SwinTransformerV2_3D


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class FeatureEmbedding(nn.Module):
    def __init__(self, backbone: nn.Module, decoder: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.decoder = decoder


class PharmacoNetModel(nn.Module):
    """The four forward passes used by the pipeline."""

    def __init__(self, in_channels: int = 33, image_size: int = 64, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 6, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 4, token_feature_dim: int = 192, num_interactions: int = 10):
        super().__init__()
        self.config = dict(in_channels=in_channels, image_size=image_size, embed_dim=embed_dim,
                           depths=tuple(depths), num_heads=tuple(num_heads), window=window,
                           token_feature_dim=token_feature_dim,
                           num_interactions=num_interactions)
        dims = [embed_dim * 2**i for i in range(len(depths))]
        num_convs = (1,) + (2,) * len(depths)
        self.embedding = FeatureEmbedding(
            SwinTransformerV2_3D(in_channels, image_size, 2, embed_dim, depths, num_heads, window),
            FPNDecoder((in_channels, *dims), num_convs, embed_dim),
        )
        self.cavity_head = CavityHead(embed_dim, embed_dim)
        self.token_head = TokenHead(embed_dim, num_interactions, token_feature_dim)
        self.mask_head = MaskHead(token_feature_dim, embed_dim, len(depths) + 1, num_convs)

    def forward_feature(self, image: torch.Tensor) -> list[torch.Tensor]:
        """image [B, D, H, W, 33] -> top-down pyramid [[B,4,4,4,96] .. [B,64,64,64,96]]
        (NDHWC views). The raw input is the bottom level."""
        x = to_ncdhw(image)
        pyramid = self.embedding.decoder([x, *self.embedding.backbone(x)])
        return [to_ndhwc(p) for p in pyramid]

    def forward_cavity_extraction(self, features: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """features [B, D, H, W, 96] -> (narrow, wide) logits [B, D, H, W, 1]."""
        narrow, wide = self.cavity_head(to_ncdhw(features))
        return to_ndhwc(narrow), to_ndhwc(wide)

    def forward_token_prediction(self, features: torch.Tensor, tokens: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """features [1, D, H, W, 96], tokens [T, 4] -> (logits [T], feats [T, 192])."""
        return self.token_head(to_ncdhw(features)[0], tokens)

    def forward_segmentation(self, multi_scale_features: list[torch.Tensor],
                             tokens: torch.Tensor, token_features: torch.Tensor
                             ) -> torch.Tensor:
        """-> [K, D, H, W] mask logits."""
        return self.mask_head([to_ncdhw(p) for p in multi_scale_features], tokens,
                              token_features)


def build_model(image_size: int = 64, **kwargs) -> PharmacoNetModel:
    """The published-checkpoint architecture by default; kwargs override
    for reduced test configurations."""
    return PharmacoNetModel(image_size=image_size, **kwargs)
