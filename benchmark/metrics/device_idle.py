"""device_idle: share of the traced window with neither a kernel nor a
copy on the card, in percent."""

import device_trace


def read(records):
    tl = records.get("timeline")
    w = device_trace.window_bounds(tl) if tl else None
    busy = device_trace.busy_ns(tl) if tl else None
    if w is None or busy is None:
        return None
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
