"""kernels_mfu: the window's model operations (model_flops.py) over the
summed time of the traced window's kernels times the card's published
float32 rate outside the tensor cores, in percent: how near the card's own
work comes to its peak, apart from the host's time."""

import device_trace
import model_flops
from roofline import F32_OPS_PER_S


def read(records):
    tl, ops = records.get("timeline"), model_flops.window_ops(records)
    w = device_trace.window_bounds(tl) if tl else None
    if w is None or not ops:
        return None
    ns = sum(min(e, w[1]) - max(s, w[0]) for _, s, e, is_copy in tl["device"]
             if not is_copy and e > w[0] and s < w[1])
    return 100.0 * ops / (ns / 1e9 * F32_OPS_PER_S) if ns else None
