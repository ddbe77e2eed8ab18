"""Overlap bucketing on the card, ``core/bucketing.py`` (the
``bucketing.overlap`` span) and ``kernels/ops.py::prepare_tiles``'s padding
of the buckets to the chunk (``bucketing.pad``, where it pads), ms of the
card's stream between their opening and close (median over the profiled
queries)."""
from stkde_bench import spans


def read(rec):
    return spans.per_query(rec, spans.device_ms(
        "bucketing.overlap", optional=("bucketing.pad",)))
