"""Host syncs a query makes, counted inside the program: each synchronising
CUDA operation that torch's sync debug mode reports while a ``stkde.query``
span is open, and each wait counted by hand, summed over the query's spans
(their ``syncs``); the median over the profiled queries."""
from stkde_bench import spans


def _syncs(q):
    counts = [sp.attrs.get("syncs") for group in q.values() for sp in group]
    return None if None in counts else sum(counts)


def read(rec):
    return spans.per_query(rec, _syncs)
