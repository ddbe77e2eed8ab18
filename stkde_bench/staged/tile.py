"""``stkde(points, dom, use_tiled_kernel=True)`` stage by stage, as
``core/api.py::stkde`` and ``kernels/ops.py::stkde_tiled`` call them, with
the card synchronised between the stages. The run checks the grid it
returns, and its summed time, against a real query of the same inputs."""
import time

from stkde_bench.harness import sync


def run(pts, dom, dev, stages, counters):
    from repro_torch import convert
    from repro_torch._device import points_to_device
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.kernels.stkde_tile import stkde_tiles_cuda
    from repro_torch.resilience.degrade import ensure_finite

    t0 = time.perf_counter()
    p = api.validate_inputs(pts, dom)
    t1 = time.perf_counter()
    on_card = points_to_device(p, dev)
    sync(dev)
    t2 = time.perf_counter()
    tile = ops.default_tile(dom)
    b, chunk = ops.prepare_tiles(on_card, dom, tile)
    sync(dev)
    t3 = time.perf_counter()
    t = convert.buckets_to_torch(b.points, b.valid, b.counts, tile, b.cap,
                                 device=dev)
    padded = stkde_tiles_cuda(t.pts_tiles, t.valid_tiles, dom, tile, t.cap,
                              len(p), chunk, counts=t.counts.cpu())
    t4 = time.perf_counter()
    sync(dev)
    t5 = time.perf_counter()
    grid = ensure_finite(padded[: dom.Gx, : dom.Gy, : dom.Gt], "stkde.tiled")
    sync(dev)
    t6 = time.perf_counter()
    for name, s in (("entry", t1 - t0), ("h2d", t2 - t1),
                    ("bucketing", t3 - t2), ("tile_call", t4 - t3),
                    ("kernel_wait", t5 - t4), ("finish", t6 - t5)):
        stages.setdefault(name, []).append(s)
    counters.setdefault("bucket_bytes", []).append(
        t.pts_tiles.nbytes + t.valid_tiles.nbytes)
    return grid
