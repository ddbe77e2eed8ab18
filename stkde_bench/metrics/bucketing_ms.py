"""Overlap bucketing on the card, ``kernels/ops.py::prepare_tiles`` ->
``core/bucketing.py``, ms (staged query, median)."""


def read(rec):
    return rec.stage_ms("bucketing")
