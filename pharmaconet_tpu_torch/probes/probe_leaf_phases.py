"""Where the stored route's device time goes: K2 and the torch leaf chain
split into cumulative phases on the headline batch (bench.py's 20-cluster
model seed 0, --n ligands x 4 conformers seed 1, one v3 store batch with
the leaves baked on the device, the prepack CLI's default layout and wire).

    python -m pharmaconet_tpu_torch.probes.probe_leaf_phases [--n 2048] [--device cuda]

  A  K2 alone (`ops/screen_cuda.score_tiles_v3_rows`)
  B  A + the window gather of every bucket (`leaf_tree._window`)
  C  B + the products: each bucket's planes (unpacked, or scattered from
     the sparse wire) and its two batched products, S and the dead count
  D  the whole chain, `leaf_tree.leaf2_scores_multi` (C + each bucket's
     epilogue, the scatter to batch order and the outlier rows)
  E  the S contraction alone, in full f32 (the chain's), as one TF32 pass
     and as three bf16 passes over an exact three-way split of the window
     (`screen_ref.split_bf16`), each held against f32: its largest
     deviation and the scores it moves beyond rtol 2e-5 / atol 1e-4.
     Reported only: the chain stays f32 (`leaf_tree._require_f32_matmul`).

Each phase is timed back to back (`stream_ms`) over the batch's operands
on the device; the deltas attribute the chain. Gate: D's scores, with the
outliers' host DFS, equal the screening CLI's `--library_tiles` CSV on the
same store within rtol 2e-5 / atol 1e-4. The counterpart of the JAX
`probes/probe_leaf_phases.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from . import stored_route as sr
from .stored_route import log


def build_parser():
    return sr.parser(__doc__.splitlines()[0], 2048, "ligands (one stored batch)")


def planes(bucket, wk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A bucket's score and cross planes as f32 0/1 [Bk, Lk, Wk], as the
    chain builds them (unpacked bits, or the sparse wire's scatter)."""
    from ..scoring.leaf_tree import _scatter_ones, _unpack_bits

    if len(bucket) == 7:
        _, sidx, cidx, pw, _, _, shp = bucket
        shape = (pw.shape[0], shp.shape[0], wk)
        size = shape[0] * shape[1] * wk
        return _scatter_ones(sidx, size).reshape(shape), _scatter_ones(cidx, size).reshape(shape)
    return _unpack_bits(bucket[1], wk), _unpack_bits(bucket[2], wk)


def windows(ops: sr.Operands, rows: torch.Tensor) -> list[torch.Tensor]:
    from ..scoring.leaf_tree import _window

    rows_z = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    return [_window(rows_z, b[0], b[3]) for b in ops.buckets]


def products(ops: sr.Operands, rows: torch.Tensor) -> list[tuple]:
    """Phase C's work per bucket: (score plane, cross plane, window, S,
    dead count)."""
    out = []
    for b, tw in zip(ops.buckets, windows(ops, rows)):
        a_s, a_c = planes(b, tw.shape[1])
        out.append((a_s, a_c, tw, torch.bmm(a_s, tw),
                    torch.bmm(a_c, (tw <= 0.0).to(torch.float32))))
    return out


def s_bf16x3(a_s: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """S as three bf16 products over the exact split tw = hi + mid + lo
    (0/1 planes are exact in bf16), each accumulated in f32. On the CPU
    the same bf16 operands multiply in f32 (no bf16-in, f32-out product
    there): the same sums, not a bf16 time."""
    from ..ops.screen_ref import split_bf16

    parts = split_bf16(tw.contiguous())
    if a_s.is_cuda:
        a16 = a_s.to(torch.bfloat16)
        prods = [torch.bmm(a16, p.to(torch.bfloat16), out_dtype=torch.float32) for p in parts]
    else:
        prods = [torch.bmm(a_s, p) for p in parts]
    return (prods[0] + prods[1]) + prods[2]


def phase_e(ops: sr.Operands, rows: torch.Tensor, dev: torch.device, reps: int) -> dict:
    """The S contraction in three precisions, timed and held against f32."""
    from ..module import precision_scope
    from ..scoring.leaf_tree import _bucket_epilogue

    parts = products(ops, rows)

    def f32():
        with precision_scope("float32", dev):
            return [torch.bmm(a_s, tw) for a_s, _, tw, _, _ in parts]

    def tf32():
        with precision_scope("tensorfloat32", dev):
            return [torch.bmm(a_s, tw) for a_s, _, tw, _, _ in parts]

    def bf16x3():
        return [s_bf16x3(a_s, tw) for a_s, _, tw, _, _ in parts]

    def scores(s_list):
        return torch.cat([_bucket_epilogue(s, a_c, tw, b[4])
                          for s, (_, a_c, tw, _, _), b in zip(s_list, parts, ops.buckets)])

    modes = {"s_f32": f32, "s_tf32_one_pass": tf32, "s_bf16_three_passes": bf16x3}
    times = sr.times_of(dev, modes, reps)
    ref = f32()
    ref_scores = scores(ref)
    out = {}
    for name, fn in modes.items():
        got = fn()
        dev_s = max(float((g - r).abs().max()) if g.numel() else 0.0 for g, r in zip(got, ref))
        got_scores = scores(got)
        moved = int((~torch.isclose(got_scores, ref_scores, rtol=sr.RTOL, atol=sr.ATOL)).sum())
        out[name] = dict(times[name], max_abs_dev_s=dev_s,
                         max_abs_dev_scores=float((got_scores - ref_scores).abs().max()),
                         scores_moved=moved, scores=int(got_scores.numel()))
    return out


def body(args, work: Path, report: dict) -> None:
    from ..cli.screening import build_parser as screening_parser, main as screening_main
    from ..scoring.batch_screen import BatchScreener

    dev = sr.device_of(args)
    sr.pin_full_f32()
    model, pm, ligands, names = sr.headline_inputs(args.n)
    store = sr.write_store(work / "tiles", pm, ligands, names, dev, args.n)
    sb = store.load(0)
    stats = sr.store_stats(sb)
    report["store"] = stats
    log(f"batch 0: {stats}")
    screener = BatchScreener(pm, device=dev)
    ops = sr.operands(screener, sb)

    phases = {
        "A_k2": ops.rows,
        "B_gather": lambda: windows(ops, ops.rows()),
        "C_products": lambda: products(ops, ops.rows()),
        "D_chain": ops.chain,
    }
    times = sr.times_of(dev, phases, args.reps)
    per = {k: t["per_batch_ms"] for k, t in times.items()}
    deltas = dict(k2_ms=per["A_k2"], gather_ms=per["B_gather"] - per["A_k2"],
                  products_ms=per["C_products"] - per["B_gather"],
                  epilogue_ms=per["D_chain"] - per["C_products"])
    report.update(phases=times, deltas=deltas)
    for k, t in times.items():
        log(f"{k}: {t['per_batch_ms']:.4f} ms per batch")
    log("deltas: " + ", ".join(f"{k} {v:.4f}" for k, v in deltas.items()))
    report["phase_e"] = phase_e(ops, ops.rows(), dev, args.reps)
    for k, v in report["phase_e"].items():
        log(f"E {k}: {v['per_batch_ms']:.4f} ms, S off f32 by {v['max_abs_dev_s']:.3g}, "
            f"{v['scores_moved']} of {v['scores']} scores moved beyond the tolerance")

    # gate: D with the outliers' host DFS against the --library_tiles CLI
    scores = sr.batch_scores(screener, sb, ops.chain())
    model_path, out_csv = work / "model.pm", work / "tiles.csv"
    model.save(str(model_path))
    rc = screening_main(screening_parser().parse_args([
        "-p", str(model_path), "--library_tiles", str(work / "tiles"), "-o", str(out_csv),
        "--device", str(dev)]))
    if rc != 0:
        raise sr.ProbeError(f"screening --library_tiles exited {rc}")
    csv = sr.scale.read_scores(out_csv)
    report["gate"] = sr.gate_scores("D against --library_tiles", scores,
                                    [csv[name] for name in names])
    log(f"gate: D equals the --library_tiles CSV ({report['gate']})")


def main(argv: list[str] | None = None) -> int:
    return sr.run("probe_leaf_phases", build_parser().parse_args(argv), body)


if __name__ == "__main__":
    sys.exit(main())
