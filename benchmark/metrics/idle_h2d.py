"""idle_h2d: percent of the traced window in which the card runs neither a
kernel nor a copy while the screening thread is in the program's
`pmnet.dispatch.h2d` span (the pageable copy to the card)."""

import program_spans


def read(records):
    return program_spans.idle_share(records, ("pmnet.dispatch.h2d",))
