"""The leaf wire split into the copy and the device chain: batch 0 of a
dense-wire and a sparse-wire store of one library (probe_sparse_wire's),
measured in turns in one process.

    python -m pharmaconet_tpu_torch.probes.probe_sparse_split [--n 2048] \\
        [--stores DIR] [--copies 9] [--device cuda]

  T  the host-to-device copy of the stored batch's operand tree, array by
     array the way `BatchScreener._to_device` copies it (a read-only store
     mapping copied out first, then a copy from pageable memory),
     synchronised: host-clock median of --copies rounds, the wires in
     turns after one warm-up round, and MB/s. Beside it, printed only, the
     same arrays copied from pinned memory (`non_blocking`; the staging
     into pinned buffers is not timed). Nothing in `scoring/` changes.
  D  the device chain (K2 + `leaf_tree.leaf2_scores_multi`) with the
     operands resident, back to back (`stream_ms`), the wires in turns:
     what the sparse wire's scatter costs on the device.

--stores names a kept probe_sparse_wire work directory (its model.pm,
tiles_dense and tiles_sparse); without it the probe builds them here at
--n SMILES (`probe_sparse_wire.build_stores`). Gate: both wires' chains
give the same batch scores within rtol 2e-5 / atol 1e-4. The counterpart
of the JAX `probes/probe_sparse_split.py`, which wrote `SPARSE_SPLIT.json`
into the repo; this probe writes only its report.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import probe_sparse_wire
from . import stored_route as sr
from .stored_route import log


def build_parser():
    p = probe_sparse_wire.store_parser(__doc__.splitlines()[0], 2048)
    p.add_argument("--stores", default=None,
                   help="a probe_sparse_wire work directory to read the two stores from")
    p.add_argument("--copies", type=int, default=9, help="timed copy rounds")
    return p


def median_s(fns: dict, rounds: int, dev: torch.device) -> dict:
    """{name: median host seconds} of each call, synchronised, the calls
    in turns over `rounds` rounds after one untimed round."""
    runs = {name: [] for name in fns}
    for r in range(rounds + 1):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            out = fn()
            sr.sync(dev)
            if r:
                runs[name].append(time.perf_counter() - t0)
            del out
    return {name: statistics.median(t) for name, t in runs.items()}


def body(args, work: Path, report: dict) -> None:
    from ..pharmacophore.model import PharmacophoreModel
    from ..scoring.batch_screen import BatchScreener, PackedModel
    from ..scoring.tiled_store import TiledStore

    dev = sr.device_of(args)
    sr.pin_full_f32()
    if args.stores is None:
        root = work
        probe_sparse_wire.build_stores(args, work, report)
    else:
        root = Path(args.stores)
    pm = PackedModel.from_model(PharmacophoreModel.load(str(root / "model.pm")))
    screener = BatchScreener(pm, device=dev)
    batches = {wire: TiledStore(root / f"tiles_{wire}", pm).load(0)
               for wire in probe_sparse_wire.WIRES}
    arrays = {wire: sr.operand_arrays(sb) for wire, sb in batches.items()}
    mb = {wire: sum(np.asarray(a).nbytes for a in arrs) / 1e6 for wire, arrs in arrays.items()}
    copies = median_s({w: lambda arrs=arrs: [screener._to_device(a) for a in arrs]
                       for w, arrs in arrays.items()}, args.copies, dev)
    pinned = {}
    if dev.type == "cuda":  # pinned host memory needs a card
        staged = {w: [torch.from_numpy(np.array(a)).pin_memory() for a in arrs]
                  for w, arrs in arrays.items()}
        pinned = median_s({w: lambda bufs=bufs: [b.to(dev, non_blocking=True) for b in bufs]
                           for w, bufs in staged.items()}, args.copies, dev)
    ops = {wire: sr.operands(screener, sb) for wire, sb in batches.items()}
    chain = sr.times_of(dev, {wire: o.chain for wire, o in ops.items()}, args.reps)
    for wire in batches:
        rec = dict(operand_mb=mb[wire], arrays=len(arrays[wire]),
                   copy_ms=copies[wire] * 1e3, copy_mb_per_s=mb[wire] / copies[wire],
                   chain=chain[wire], chain_ms=chain[wire]["per_batch_ms"],
                   store=sr.store_stats(batches[wire]))
        if wire in pinned:
            rec.update(pinned_copy_ms=pinned[wire] * 1e3,
                       pinned_mb_per_s=mb[wire] / pinned[wire])
        report[wire] = rec
        log(f"{wire}: {mb[wire]:.2f} MB in {len(arrays[wire])} arrays; copy "
            f"{rec['copy_ms']:.3f} ms ({rec['copy_mb_per_s']:,.0f} MB/s)"
            + (f", pinned {rec['pinned_copy_ms']:.3f} ms ({rec['pinned_mb_per_s']:,.0f} MB/s)"
               if wire in pinned else "")
            + f"; chain {rec['chain_ms']:.4f} ms")
    scores = {wire: sr.batch_scores(screener, batches[wire], ops[wire].chain()) for wire in ops}
    report["gate"] = sr.gate_scores("sparse chain against dense chain", scores["sparse"],
                                    scores["dense"])
    log(f"gate: the wires' scores agree ({report['gate']})")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_sparse_split", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
