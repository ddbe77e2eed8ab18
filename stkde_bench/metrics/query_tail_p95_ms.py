"""95th percentile of a traced run's window of query times, ms: the same
quantity as ``query_p95_ms``, read per layer where the host sets the tail
too unsteadily for an end-to-end bound."""
import statistics


def read(rec):
    if len(rec.latencies_s) < 2:
        return None
    q = statistics.quantiles(rec.latencies_s, n=100, method="inclusive")
    return 1e3 * q[94]
