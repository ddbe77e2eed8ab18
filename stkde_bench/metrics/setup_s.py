"""Seconds from the start of the process to the first timed query: imports,
the CUDA context, the tile library (built on a checkout's first run), the
point sets and the warm-up queries."""


def read(rec):
    return rec.setup_s
