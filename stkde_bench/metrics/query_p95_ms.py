"""95th percentile of the window's query times, ms: each query from the call
into ``stkde`` until ``torch.cuda.synchronize()`` after it returns."""
import statistics


def read(rec):
    if len(rec.latencies_s) < 2:
        return None
    q = statistics.quantiles(rec.latencies_s, n=100, method="inclusive")
    return 1e3 * q[94]
