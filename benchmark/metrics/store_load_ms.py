"""store_load_ms: mean host ms per batch of the store read on the prefetch
thread, `TiledStore.load` plus its page-in, timed around each call."""


def read(records):
    spans = records.get("spans") or {}
    loads = spans.get("bench.load", [])
    if not loads:
        return None
    return 1e3 * (sum(loads) + sum(spans.get("bench.page_in", []))) / len(loads)
