"""Share of the (point, voxel) pairs the tile kernel walks at which both
``Ks`` and ``Kt`` are non-zero: the support pairs of the profiled queries
(``roofline.py``) over the ``walked_pairs`` of their ``stkde.tile.plan``
spans, each a mean over its queries, %."""
import statistics

from stkde_bench import spans


def read(rec):
    walked = spans.values(rec, spans.attr("stkde.tile.plan", "walked_pairs"))
    if not rec.least or not walked or not statistics.fmean(walked):
        return None
    support = statistics.fmean(x["support_pairs"] for x in rec.least)
    return 100.0 * support / statistics.fmean(walked)
