"""copy_gbps: the bytes the screener hands to the card (counted at
`BatchScreener._to_device`) over the summed time of the traced window's
`Memcpy HtoD` operations on the card, in GB/s."""

import device_trace


def read(records):
    tl, nbytes = records.get("timeline"), (records.get("counts") or {}).get("copy_bytes")
    w = device_trace.window_bounds(tl) if tl else None
    if w is None or not nbytes:
        return None
    ns = sum(min(e, w[1]) - max(s, w[0]) for name, s, e, is_copy in tl["device"]
             if is_copy and "HtoD" in name and e > w[0] and s < w[1])
    return nbytes / ns if ns else None
