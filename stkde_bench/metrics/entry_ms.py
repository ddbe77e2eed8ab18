"""Entry ``core/api.py::stkde``: ``validate_inputs`` on the host, ms
(staged query, median)."""


def read(rec):
    return rec.stage_ms("entry")
