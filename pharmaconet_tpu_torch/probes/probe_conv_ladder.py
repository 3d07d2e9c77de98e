"""The mask decoder's 3x3x3 96->96 convolution at 64^3 against the card's
peak: library calls only (cuDNN's `F.conv3d`, cuBLAS's `torch.matmul`);
no kernel of the port and no path of it changes.

    python -m pharmaconet_tpu_torch.probes.probe_conv_ladder [--n 16] \\
        [--grid 64] [--device cuda]

On x [B, 96, D, D, D] (B = --n, D = --grid) with weights scaled to keep
unit variance, each rung timed back to back (`stream_ms`), in f32 and in
TF32 (`module.precision_scope`):

  conv96         F.conv3d(x, w, padding=1)
  conv96_affine  the same, then the per-channel affine and ReLU (the
                 decoder's BaseConv3d composition)
  conv128        channels padded to 128 on both sides
  shift27        the same convolution as 27 shifted `torch.matmul`s over
                 the channels-last padded input (K = 96)

Rate: 2 * D^3 * 27 * Cin * Cout * B operations per call, in TFLOP/s
against the published H100 SXM peaks (67 TFLOP/s f32 outside the tensor
cores, 495 TF32 dense). When B does not fit the card beside cuDNN's
workspace (the allocator raises), B halves until it does and the report
says so. Gate: shift27 in f32 equals conv96 in f32 within rtol 2e-5 /
atol 1e-4 (the same sums in another order). The counterpart of the JAX
`probes/probe_conv_ladder.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import stored_route as sr
from .stored_route import log

PEAK_TFLOPS = {"f32": 67.0, "tf32": 495.0}  # H100 SXM data sheet, dense
PRECISION = {"f32": "float32", "tf32": "tensorfloat32"}


def build_parser():
    p = sr.parser(__doc__.splitlines()[0], 16, "batch B of the convolution")
    p.add_argument("--grid", type=int, default=64, help="the map's edge D")
    return p


def shift27(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3d(x, w, padding=1) as 27 shifted channel products, channels
    last: x [B, C, D, D, D], w [O, C, 3, 3, 3] -> [B, O, D, D, D]."""
    d = x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1)).permute(0, 2, 3, 4, 1)  # [B, D+2, D+2, D+2, C]
    out = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                t = torch.matmul(xp[:, dz:dz + d, dy:dy + d, dx:dx + d, :],
                                 w[:, :, dz, dy, dx].t())
                out = t if out is None else out + t
    return out.permute(0, 4, 1, 2, 3)


def rungs(b: int, d: int, dev: torch.device) -> tuple[dict, dict]:
    """({name: fn}, {name: operations per call}) at batch b."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x96, x128 = normal(b, 96, d, d, d, scale=0.1), normal(b, 128, d, d, d, scale=0.1)
    w96 = normal(96, 96, 3, 3, 3, scale=(27 * 96) ** -0.5)
    w128 = normal(128, 128, 3, 3, 3, scale=(27 * 128) ** -0.5)
    scale, bias = normal(1, 96, 1, 1, 1), normal(1, 96, 1, 1, 1)
    fns = {
        "conv96": lambda: F.conv3d(x96, w96, padding=1),
        "conv96_affine": lambda: torch.relu(F.conv3d(x96, w96, padding=1) * scale + bias),
        "conv128": lambda: F.conv3d(x128, w128, padding=1),
        "shift27": lambda: shift27(x96, w96),
    }
    ops = {k: 2.0 * d**3 * 27 * (128 * 128 if k == "conv128" else 96 * 96) * b for k in fns}
    return fns, ops


def measure(b: int, d: int, dev: torch.device, reps: int) -> dict:
    from ..module import precision_scope

    fns, ops = rungs(b, d, dev)
    with precision_scope("float32", dev):
        gate = sr.gate_rows("shift27 against conv96 (f32)", fns["shift27"](), fns["conv96"]())
    out = {"gate": gate}
    for prec, scope in PRECISION.items():
        def scoped(fn, scope=scope):
            def call():
                with precision_scope(scope, dev):
                    return fn()
            return call
        times = sr.times_of(dev, {k: scoped(fn) for k, fn in fns.items()}, reps)
        for k, t in times.items():
            rate = ops[k] / (t["per_batch_ms"] * 1e-3) / 1e12 if dev.type == "cuda" else None
            out[f"{k}_{prec}"] = dict(t, ops=ops[k], tflops=rate,
                                      peak_share=rate and rate / PEAK_TFLOPS[prec])
    return out


def body(args, work: Path, report: dict) -> None:
    dev = sr.device_of(args)
    b, why = args.n, None
    while True:
        try:
            result = measure(b, args.grid, dev, args.reps)
            break
        except torch.cuda.OutOfMemoryError as exc:
            if b == 1:
                raise
            why = f"B = {b} did not fit beside the workspace: {str(exc).splitlines()[0]}"
        log(why)  # the failed attempt's tensors are freed once its frames are
        torch.cuda.empty_cache()
        b //= 2
    report.update(batch=b, asked_batch=args.n, grid=args.grid, cut_reason=why,
                  peaks_tflops=PEAK_TFLOPS, **result)
    log(f"B {b}, grid {args.grid}^3; shift27 equals conv96 in f32 ({result['gate']})")
    for k, v in result.items():
        if k != "gate":
            rate = (f", {v['tflops']:.2f} TFLOP/s ({v['peak_share']:.1%} of the peak)"
                    if v["tflops"] is not None else " (host clock)")
            log(f"{k}: {v['per_batch_ms']:.3f} ms{rate}")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_conv_ladder", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
