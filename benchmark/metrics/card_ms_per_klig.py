"""card_ms_per_klig: milliseconds of the window in which a kernel or a
copy ran on the card, per 1000 ligands scored by the window's passes: the
card time a screen takes, whatever the host does meanwhile."""

import device_trace


def read(records):
    tl = records.get("timeline")
    busy = device_trace.busy_ns(tl) if tl else None
    if not busy or not records["items"]:
        return None
    return busy / 1e6 / (records["items"] / 1e3)
