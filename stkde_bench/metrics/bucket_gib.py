"""Memory of the padded buckets the tile kernel reads: ``pts_tiles`` +
``valid_tiles``, GiB, from their shapes (staged query, median)."""
import statistics


def read(rec):
    b = rec.counters.get("bucket_bytes")
    return statistics.median(b) / 2**30 if b else None
