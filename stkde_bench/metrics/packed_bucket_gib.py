"""Memory of the packed buckets the tile kernel reads: the points and the
offsets, the ``bytes`` of the ``bucketing.pack`` span, GiB (median over the
profiled queries). A program without that span gives nothing."""
from stkde_bench import spans


def _gib(q):
    b = spans.attr("bucketing.pack", "bytes")(q)
    return None if b is None else b / 2**30


def read(rec):
    return spans.per_query(rec, _gib)
