"""h2d_host_ms: mean host ms per batch that the screening thread spends
in the pageable copy to the card (`pmnet.dispatch.h2d`, the program's span
around `.to(device)` in `BatchScreener._to_device`)."""

import program_spans


def read(records):
    return program_spans.per_batch_ms(records, "pmnet.dispatch.h2d")
