"""Overlap bucketing into the packed layout on the card, ``core/bucketing.py::
bucket_points_packed``: the copies enumerated (the ``bucketing.overlap``
span) and sorted into runs with their offsets and the loads copied back
(``bucketing.pack``), ms of the card's stream between the first's opening
and the second's close (median over the profiled queries). A program without
the ``bucketing.pack`` span gives nothing."""
from stkde_bench import spans


def read(rec):
    return spans.per_query(rec, spans.device_ms("bucketing.overlap",
                                                "bucketing.pack"))
