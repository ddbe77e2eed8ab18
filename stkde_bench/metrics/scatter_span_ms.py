"""The PB-SYM scatter ``core/pb.py::_pb_impl``, ms of the card's stream
between the opening and the close of its ``stkde.scatter`` span (median
over the profiled queries)."""
from stkde_bench import spans


def read(rec):
    return spans.per_query(rec, spans.device_ms("stkde.scatter"))
