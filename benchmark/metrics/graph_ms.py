"""graph_ms: host ms a pocket in `PharmacophoreModel.create` (density_map.py's
components, nodes, edges and clusters) and the `.pm` write, spans
`bench.graph` and `bench.save`."""

import stage_ms


def read(records):
    return stage_ms.per_item(records, "bench.graph", "bench.save")
