"""parse_ms: host ms a pocket in `PharmacoNet.parse` (the PDB, pocket
extraction, token featurization, atom features, padding), span
`bench.parse`."""

import stage_ms


def read(records):
    return stage_ms.per_item(records, "bench.parse")
