"""copy_out_ms: mean host ms per batch that the screening thread spends
copying read-only store arrays out of their mappings
(`pmnet.dispatch.copy_out`, the program's span in
`BatchScreener._to_device`)."""

import program_spans


def read(records):
    return program_spans.per_batch_ms(records, "pmnet.dispatch.copy_out")
