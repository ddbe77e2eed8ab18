"""``resilience/degrade.py::ensure_finite`` on the query's grid, ms of the
card's stream between the opening and the close of its ``stkde.finish``
span (median over the profiled queries)."""
from stkde_bench import spans


def read(rec):
    return spans.per_query(rec, spans.device_ms("stkde.finish"))
