"""tail_ms: mean host ms per batch of `BatchScreener.postprocess_stored`
(the wait for the batch's scores, the outliers' DFS), timed around each
call."""


def read(records):
    tails = (records.get("spans") or {}).get("bench.tail", [])
    return 1e3 * sum(tails) / len(tails) if tails else None
