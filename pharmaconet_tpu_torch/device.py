"""The device an entry point runs on, and the CPU math set up once per
process."""

from __future__ import annotations

import torch


def set_up_cpu_vector_math() -> None:
    """Set up MKL's vector math on one thread, before any other call.

    On the CPU torch's exp, sqrt, log, tanh and their kin run MKL's vector
    math, which sets itself up lazily on its first call in a process. When
    that first call runs on several OpenMP threads at once, a thread that
    arrives while the set-up runs computes its whole share about 1.5e-4
    relative off (later calls are right), so one screen could write
    different scores in two fresh processes. One call of any of these
    functions on one thread (a tensor far below torch's parallel grain)
    sets it up for all of them; the package calls this on import
    (`probes/probe_reproducible.py --first_calls` shows the race and the
    repair)."""
    torch.exp(torch.zeros(1))


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
