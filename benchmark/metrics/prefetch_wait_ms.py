"""prefetch_wait_ms: mean ms per batch that the screening thread waits for
the store's prefetch thread (`pmnet.store.wait`, the program's span around
the queue read in `TiledStore.iter_loaded`)."""

import program_spans


def read(records):
    return program_spans.per_batch_ms(records, "pmnet.store.wait")
