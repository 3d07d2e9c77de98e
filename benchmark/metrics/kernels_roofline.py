"""kernels_roofline: the least time the window's work needs on the chip
(the larger of its f32 operations over 67 TFLOP/s and its bytes over
3.35 TB/s, counted from the generated model and ligands by roofline.py)
over the summed time of the window's kernels, in percent."""

import device_trace
import roofline


def read(records):
    tl, work = records.get("timeline"), records.get("work")
    w = device_trace.window_bounds(tl) if tl else None
    if w is None or not work:
        return None
    ns = sum(min(e, w[1]) - max(s, w[0]) for _, s, e, is_copy in tl["device"]
             if not is_copy and e > w[0] and s < w[1])
    if not ns:
        return None
    least, _ = roofline.least_seconds(work["ops"], work["bytes"])
    return 100.0 * least / (ns / 1e9)
