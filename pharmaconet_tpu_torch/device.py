"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for an entry point. Asking for CUDA without a visible
    card raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
