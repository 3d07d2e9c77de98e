"""idle_copy_out: percent of the traced window in which the card runs
neither a kernel nor a copy while the screening thread is in the
program's `pmnet.dispatch.copy_out` span (copying read-only store arrays
out of their mappings)."""

import program_spans


def read(records):
    return program_spans.idle_share(records, ("pmnet.dispatch.copy_out",))
