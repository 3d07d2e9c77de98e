"""Ways to write the leaf window gather in torch, on the headline stored
batch's own rows and indices (bench.py's 20-cluster model seed 0, --n
ligands x 4 conformers seed 1, one v3 store batch with baked leaves).

    python -m pharmaconet_tpu_torch.probes.probe_gather_variants [--n 2048] [--device cuda]

The window is the K2 rows (with the appended zero row) at every leaf
slot of the batch, every bucket's ends2 in one index, as one [S, C]
table:

  g0  indexing: rows_z[ends2]
  g1  transposed table: rows_zT[:, ends2], read back as [S, C]
  g2  per component: C one-dimensional gathers, stacked
  g3  real slots only (those not on the zero row), scattered into a zero
      window
  g4  g3's slots gathered in ascending source order, then put back in
      slot order by the inverse permutation (the JAX probe applied the
      sort permutation itself there, which only its timing survived)
  g5  8-row granules gathered (ends2 >> 3), the row picked by a one-hot
      [S, 1, 8] x [S, 8, C] `torch.matmul` in full f32 (the JAX probe's
      granule8)
  window  what the chain runs: `index_select` along the rows
      (`leaf_tree._window`, before its reshape and prune)

Each is timed back to back (`stream_ms`). Also printed: the quantiles of
the batch's pairs, non-empty pairs and blocks per ligand. Gate: every
variant's window equals g0's bit for bit. The counterpart of the JAX
`probes/probe_gather_variants.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from . import stored_route as sr
from .stored_route import log

QUANTILES = (50, 90, 97, 99, 100)


def build_parser():
    return sr.parser(__doc__.splitlines()[0], 2048, "ligands (one stored batch)")


def ligand_quantiles(pm, ligands) -> dict:
    """Quantiles of pairs, non-empty pairs (a pair-end row in the v3
    layout) and blocks per ligand of the batch."""
    from ..scoring.batch_screen import BatchScreener, build_batch

    batch = build_batch(pm, [p for p in ligands if p.clusters])
    vb = BatchScreener(pm, engine="v3", device="cpu").build_vb(batch)
    n = len(batch.pair_slices)
    pair_lig = batch.pair_meta[:, 0].astype(np.int64)
    per = dict(
        pairs=np.array([e - s for s, e in batch.pair_slices]),
        nonempty_pairs=np.bincount(pair_lig[vb.pair_end_rows >= 0], minlength=n),
        blocks=np.bincount(pair_lig[batch.block_pair], minlength=n))
    return {k: {f"q{q}": float(np.percentile(v, q)) for q in QUANTILES} for k, v in per.items()}


def variants(rows_z: torch.Tensor, ends2: torch.Tensor) -> dict:
    """{name: fn() -> [S, C] window}: the six ways and the chain's own,
    their index preparation done here, once."""
    c, zero_row = rows_z.shape[1], rows_z.shape[0] - 1
    rows_zt = rows_z.t().contiguous()
    real = ends2 != zero_row
    slots = torch.nonzero(real).squeeze(1)
    src = ends2[slots]
    order = torch.argsort(src, stable=True)
    src_sorted, inverse = src[order], torch.argsort(order)
    granules = torch.cat([rows_z, rows_z.new_zeros(-rows_z.shape[0] % 8, c)]).reshape(-1, 8 * c)
    g_idx = ends2 >> 3
    pick = (torch.arange(8, device=ends2.device) == (ends2 & 7)[:, None]).to(rows_z.dtype)

    def scatter(vals):
        return rows_z.new_zeros(ends2.numel(), c).index_copy_(0, slots, vals)

    return {
        "g0": lambda: rows_z[ends2],
        "g1": lambda: rows_zt[:, ends2].t(),
        "g2": lambda: torch.stack([rows_z[:, j][ends2] for j in range(c)], dim=-1),
        "g3": lambda: scatter(rows_z[src]),
        "g4": lambda: scatter(rows_z[src_sorted][inverse]),
        "g5": lambda: torch.matmul(pick[:, None, :],
                                   granules[g_idx].reshape(-1, 8, c)).squeeze(1),
        "window": lambda: rows_z.index_select(0, ends2),
    }


def body(args, work: Path, report: dict) -> None:
    from ..scoring.batch_screen import BatchScreener

    dev = sr.device_of(args)
    sr.pin_full_f32()
    _, pm, ligands, names = sr.headline_inputs(args.n)
    report["ligand_quantiles"] = ligand_quantiles(pm, ligands)
    for k, q in report["ligand_quantiles"].items():
        log(f"{k} per ligand: " + ", ".join(f"{a} {v:.0f}" for a, v in q.items()))
    store = sr.write_store(work / "tiles", pm, ligands, names, dev, args.n)
    sb = store.load(0)
    ops = sr.operands(BatchScreener(pm, device=dev), sb)
    rows = ops.rows()
    rows_z = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    ends2 = torch.cat([b[0] for b in ops.buckets]).long()
    real = int((ends2 != rows.shape[0]).sum())
    report.update(slots=ends2.numel(), real_slots=real,
                  table_rows=rows_z.shape[0], conformer_slots=rows_z.shape[1])
    log(f"{ends2.numel()} window slots ({real} on kernel rows) from a "
        f"[{rows_z.shape[0]}, {rows_z.shape[1]}] table")
    fns = variants(rows_z, ends2)
    want = fns["g0"]().contiguous()
    bits = want.view(torch.int32)
    for name, fn in fns.items():
        got = fn().contiguous()
        if got.shape != want.shape or not torch.equal(got.view(torch.int32), bits):
            raise sr.ProbeError(f"{name}: its window is not g0's bit for bit")
    times = sr.times_of(dev, fns, args.reps)
    report["variants"] = times
    for name, t in times.items():
        log(f"{name}: {t['per_batch_ms']:.4f} ms per batch (bit-equal to g0)")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_gather_variants", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
