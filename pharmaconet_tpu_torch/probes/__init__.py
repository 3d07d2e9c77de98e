"""Kernel probes on the card: the counterparts of the repo's `probes/`
scripts whose Pallas kernels (P1-P4) the port carries as hand-written CUDA
(csrc/screen_fused.cu, wrappers in ops/screen_cuda.py).

    python -m pharmaconet_tpu_torch.probes.probe_pallas_screen  # P1, P2
    python -m pharmaconet_tpu_torch.probes.probe_fused_split    # P3: K1's ablations
    python -m pharmaconet_tpu_torch.probes.probe_kernel_r3      # P4: K1's variants

Each takes `--device cuda|cpu` (default cuda; cuda without a card raises)
and `--ligands N` (default 2048, the headline batch), checks its kernels
before it times them, and ends with one JSON line of its kernels' launch
counts and times. On the card each line gives a call's time back to back
(the card's own time, which the shares and ligands/s use), the host's time
to enqueue it, and one call's time between two events (host work
included);
`--device cpu` runs the plain torch versions and times them on the host
clock. `prep.py` builds the inputs, `timing.py` times them.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops import screen_cuda
from .prep import HEADLINE_LIGANDS
from .timing import Times


RTOL, ATOL = 2e-5, 1e-4  # repo score tolerance


def agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int, bool]:
    """(max |diff|, -1 mismatches, within rtol/atol with no mismatch)."""
    diff = float((got - want).abs().max())
    mism = int(((got == -1.0) != (want == -1.0)).sum())
    return diff, mism, mism == 0 and torch.allclose(got, want, rtol=RTOL, atol=ATOL)


def parse_args(description: str, argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--ligands", type=int, default=HEADLINE_LIGANDS)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def device_line(device: torch.device) -> str:
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)} (torch {torch.__version__})"
    return "device: cpu (plain torch versions; times on the host clock)"


def time_line(label: str, t: Times, ligands: int) -> str:
    rate = f"-> {ligands / t.per_batch * 1e3:,.0f} lig/s"
    if t.stream_ms is None:
        return f"{label}: {t.ms:.4f} ms/batch (host clock) {rate}"
    gaps = "" if t.gapless else ", NOT gapless"
    return (f"{label}: {t.stream_ms:.4f} ms/batch back to back (enqueue {t.enqueue_ms:.4f} ms"
            f"{gaps}), one call {t.ms:.4f} ms {rate}")


def launch_line(probe: str, device: torch.device, kernels: tuple[str, ...],
                times: dict[str, Times]) -> str:
    """The probe's last line: its kernels' launch counts in this process
    and the times of each kernel and mode, by the names of chip_smoke's
    kernels line."""
    modes = {k: v for k, v in screen_cuda.MODE_LAUNCHES.items()
             if k.split("[")[0] in kernels}
    return json.dumps({"probe": probe, "device": str(device),
                       "launches": {k: screen_cuda.LAUNCHES[k] for k in kernels},
                       "mode_launches": modes,
                       "times": {k: t.as_dict() for k, t in times.items()}})
