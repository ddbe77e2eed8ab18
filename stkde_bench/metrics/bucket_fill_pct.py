"""Share of the bucket slots the tile kernel is given that hold a point:
the point copies over the tiles x ``cap`` slots, from the ``stkde.tile.plan``
span's ``copies`` and ``slots``, % (median over the profiled queries)."""
from stkde_bench import spans


def _fill(q):
    copies = spans.attr("stkde.tile.plan", "copies")(q)
    slots = spans.attr("stkde.tile.plan", "slots")(q)
    return None if copies is None or not slots else 100.0 * copies / slots


def read(rec):
    return spans.per_query(rec, _fill)
