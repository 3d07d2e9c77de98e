"""Center-crop necks (part of the public network API).

Upstream src/pmnet/network/necks/center_crop.py:4-42 and
`pharmaconet_tpu.network.necks`: crop the central region of feature maps
between backbone and decoder. The published architecture wires no neck;
kept for API parity and custom configurations. Channel-last NDHWC, as in
the JAX package.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


def center_crop(x: torch.Tensor, size: int | Sequence[int]) -> torch.Tensor:
    """Crop the spatial center of [B, D, H, W, C] to `size` (int or 3-tuple)."""
    if isinstance(size, int):
        size = (size, size, size)
    _, d, h, w, _ = x.shape
    sd, sh, sw = size
    assert sd <= d and sh <= h and sw <= w, (size, tuple(x.shape))
    od, oh, ow = (d - sd) // 2, (h - sh) // 2, (w - sw) // 2
    return x[:, od : od + sd, oh : oh + sh, ow : ow + sw, :]


class CenterCropNeck:
    """Crops each pyramid level to a target size list."""

    def __init__(self, sizes: Sequence[int | Sequence[int]]):
        self.sizes = sizes

    def __call__(self, features: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        assert len(features) == len(self.sizes)
        return [center_crop(f, s) for f, s in zip(features, self.sizes)]
