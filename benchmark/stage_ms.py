"""Host milliseconds of a route's stages, from the traced window's
`bench.*` spans (device_trace.Recorder's durations), per item the
window's passes completed."""


def per_item(records, *names: str) -> float | None:
    spans = records.get("spans") or {}
    found = [d for name in names for d in spans.get(name, [])]
    if not found or not records["items"]:
        return None
    return 1e3 * sum(found) / records["items"]
