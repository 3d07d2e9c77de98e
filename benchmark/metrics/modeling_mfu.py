"""modeling_mfu: the window's model operations (model_flops.py: the
detector's matrix products and convolutions, counted from its shapes and
the reference's kept hotspots) over the window's seconds times the card's
published float32 rate outside the tensor cores, in percent: the whole
step's share of the chip's peak."""

import model_flops
from roofline import F32_OPS_PER_S


def read(records):
    ops = model_flops.window_ops(records)
    if not ops:
        return None
    return 100.0 * ops / (records["window_s"] * F32_OPS_PER_S)
