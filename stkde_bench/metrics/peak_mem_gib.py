"""``torch.cuda.max_memory_allocated()`` over the measured window, GiB,
with the counter reset after the warm-up."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2**30
