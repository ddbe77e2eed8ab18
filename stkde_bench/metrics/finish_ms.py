"""Slice to the domain and ``resilience/degrade.py::ensure_finite``, ms
(staged query, median)."""


def read(rec):
    return rec.stage_ms("finish")
