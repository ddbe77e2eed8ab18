"""Completed queries over the whole measured window: all its work over all
its time (host clock, closed loop)."""


def read(rec):
    if not rec.window_s:
        return None
    return len(rec.latencies_s) / rec.window_s
