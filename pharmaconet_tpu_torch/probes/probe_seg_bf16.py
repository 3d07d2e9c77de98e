"""The mask decoder in three precisions on one pocket: float32 (what the
default `tensorfloat32` runs), one TF32 pass, and bfloat16 (autocast, the
opt-in `segmentation_precision="bfloat16"`), each against float32.

    python -m pharmaconet_tpu_torch.probes.probe_seg_bf16 [--n 16] \\
        [--arch full|micro] [--device cuda]

The pocket and checkpoint are chip_smoke phase 7's:
`synthetic.write_synthetic_pocket(seed=0)` and
`network.convert.synthesize_torch_state_dict(23, 0.8)` at the published
widths (--arch micro: demo_train_scale's micro trunk on its small pocket,
for the CPU). The trunk runs once (K6 on the card); then the kept
hotspots are decoded in chunks of --n (`PharmacoNet.segmentation_chunk`),
each chunk in each precision (`module.precision_scope`), and thresholded
by `PharmacoNet.postprocess`. Per precision: ms per chunk (the decoder
alone, back to back, `stream_ms`; median over the chunks), voxels whose
side of the threshold differs from float32's, the largest map difference
and its share of float32's largest value. Measured only: the default
stays as it is. The counterpart of the JAX `probes/probe_seg_bf16.py`
(which read the 6OIM example; no protein is in this repo).
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from . import stored_route as sr
from .stored_route import log

MODES = {"float32": "float32", "tf32_one_pass": "tensorfloat32", "bfloat16": "bfloat16"}
POCKET_SEED = 0


def build_parser():
    p = sr.parser(__doc__.splitlines()[0], 16, "hotspots per decoder chunk")
    p.add_argument("--arch", default="full", choices=("full", "micro"))
    return p


def build_net(args, work: Path, dev: torch.device):
    """(PharmacoNet, parsed pocket) of phase 7's pocket and checkpoint, or
    the micro trunk's."""
    from ..module import PharmacoNet
    from ..synthetic import write_synthetic_pocket
    from .demo_train_scale import MICRO_NET, MICRO_POCKET, write_checkpoint

    micro = args.arch == "micro"
    info = write_synthetic_pocket(work / "pocket.pdb", seed=POCKET_SEED,
                                  **(MICRO_POCKET if micro else {}))
    write_checkpoint(args, work)  # work / "ckpt.tar"
    kw = dict(MICRO_NET) if micro else {}
    kw["segmentation_chunk"] = args.n
    net = PharmacoNet(weight_path=work / "ckpt.tar", device=dev, verbose=False, **kw)
    if micro:
        net.focus_threshold = 0.0
    return net, net.parse(work / "pocket.pdb", center=info["center"])


def decoder_modes(net, data, modes: dict, reps: int) -> dict:
    """The mask decoder on the pocket's kept hotspots, chunk by chunk, in
    each of `modes` ({name: `module.precision_scope` precision}, the first
    the reference): per mode, ms per chunk (the decoder alone, back to
    back; median over the chunks), voxels whose side of the threshold
    differs from the reference's, the largest map difference and its
    share of the reference's largest value."""
    from ..module import precision_scope

    dev = net.device
    out = net.run_trunk(data)
    keep = np.nonzero(out["keep"].cpu().numpy())[0]
    if not len(keep):
        raise sr.ProbeError("the pocket keeps no hotspot: nothing to decode")
    tokens = torch.from_numpy(data.tokens).to(dev)
    chunk = net.segmentation_chunk
    res = {m: dict(flips=0, max_diff=0.0, ms=[]) for m in modes}
    ref_mode, largest = next(iter(modes)), 0.0
    for start in range(0, len(keep), chunk):
        part = keep[start : start + chunk]
        idx = np.zeros(chunk, dtype=np.int64)
        idx[: len(part)] = part
        valid = np.arange(chunk) < len(part)
        sel = torch.from_numpy(idx).to(dev)
        hot, feats = tokens[sel], out["token_features"][sel]

        def decode(precision):
            with torch.no_grad(), precision_scope(precision, dev):
                return net.model.forward_segmentation(out["pyramid"], hot, feats).float()

        times = sr.times_of(dev, {m: (lambda p=p: decode(p)) for m, p in modes.items()}, reps)
        density = {m: net.postprocess(out, hot, decode(p), valid)[0] for m, p in modes.items()}
        ref = density[ref_mode]
        largest = max(largest, float(ref.abs().max()))
        for m in modes:
            res[m]["ms"].append(times[m]["per_batch_ms"])
            res[m]["flips"] += int(((density[m] > 0) != (ref > 0)).sum())
            res[m]["max_diff"] = max(res[m]["max_diff"], float((density[m] - ref).abs().max()))
    return dict(hotspots=len(keep), chunk=chunk, chunks=-(-len(keep) // chunk),
                largest_value=largest, modes={
                    m: dict(ms_per_chunk=statistics.median(r["ms"]), flips=r["flips"],
                            max_diff=r["max_diff"], max_rel=r["max_diff"] / max(largest, 1e-9))
                    for m, r in res.items()})


def body(args, work: Path, report: dict) -> None:
    net, data = build_net(args, work, sr.device_of(args))
    report.update(arch=args.arch, **decoder_modes(net, data, MODES, args.reps))
    for m, r in report["modes"].items():
        log(f"{m}: {r['ms_per_chunk']:.3f} ms per chunk of {report['chunk']}, {r['flips']} "
            f"voxels across the threshold, largest map difference {r['max_diff']:.3g} "
            f"({r['max_rel']:.3g} of the largest value)")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_seg_bf16", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
