"""segment_ms: ms a pocket in `PharmacoNet._segment_kept` (the mask
decoder's chunks, ops/postprocess.py, the sparse density wire and the
hotspot records on the host), span `bench.segment`."""

import stage_ms


def read(records):
    return stage_ms.per_item(records, "bench.segment")
