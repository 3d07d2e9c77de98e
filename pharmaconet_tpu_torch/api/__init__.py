"""Developer API: PharmacoNet as a pocket encoder inside training loops.

Upstream src/pmnet/api/__init__.py:12-32 and `pharmaconet_tpu.api`. The
upstream `compile=True` option has no counterpart: the port runs eagerly.
"""

from __future__ import annotations

import torch

from ..chem.pdb import load_pdb, parse_pdb
from ..module import PharmacoNet, ProteinData

__all__ = ["PharmacoNet", "ProteinData", "get_pmnet_dev", "load_pdb", "parse_pdb"]


def get_pmnet_dev(
    device: str | torch.device = "cuda",
    score_threshold: float = 0.5,
    weight_path: str | None = None,
    **kwargs,
) -> PharmacoNet:
    """PharmacoNet configured for feature extraction (flat 0.5 threshold)
    on `device`; asking for CUDA without a card raises."""
    return PharmacoNet(weight_path=weight_path, score_threshold=score_threshold, verbose=False,
                       device=device, **kwargs)
