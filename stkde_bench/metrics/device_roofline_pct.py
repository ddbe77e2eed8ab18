"""The query's least time (``roofline.py``) over its device busy time (the
union of every kernel, copy and memset in the profiled queries), %."""


def read(rec):
    least = rec.least_s()
    if least is None or rec.trace is None:
        return None
    return 100.0 * least * rec.trace["queries"] / rec.trace["busy_s"]
