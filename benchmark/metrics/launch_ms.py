"""launch_ms: mean self ms per batch of the program's `pmnet.dispatch`
span (`BatchScreener.dispatch_stored`): its time less its copy-out and
pageable-copy children, which is the host's time launching K2 and the leaf
chain, any wait for the card inside the chain included."""

import program_spans


def read(records):
    return program_spans.self_ms(records, "pmnet.dispatch")
