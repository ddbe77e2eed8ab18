"""The PB-SYM scatter ``core/pb.py::_pb_impl`` (through ``pb``, the copy of
the points included), ms (staged query, median)."""


def read(rec):
    return rec.stage_ms("scatter")
