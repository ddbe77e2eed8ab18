"""Share of the profiled window of real queries in which no kernel, copy or
memset ran on the card, %."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
