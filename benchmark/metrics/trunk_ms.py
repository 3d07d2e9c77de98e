"""trunk_ms: ms a pocket from `PharmacoNet.run_trunk`'s start (K6
voxelizer, SwinV2-3D, FPN, cavity and token heads, gating) until the
card has finished it, as the keep set's copy to the host waits; span
`bench.trunk`."""

import stage_ms


def read(records):
    return stage_ms.per_item(records, "bench.trunk")
