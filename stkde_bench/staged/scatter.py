"""``stkde(points, dom)`` stage by stage: the PB-SYM scatter, with the card
synchronised between the stages. The run checks the grid it returns, and
its summed time, against a real query of the same inputs."""
import time

from stkde_bench.harness import sync


def run(pts, dom, dev, stages, counters):
    from repro_torch.core import api
    from repro_torch.core.pb import pb
    from repro_torch.resilience.degrade import ensure_finite

    t0 = time.perf_counter()
    p = api.validate_inputs(pts, dom)
    t1 = time.perf_counter()
    grid = pb(p, dom, variant="sym", device=dev)
    sync(dev)
    t2 = time.perf_counter()
    grid = ensure_finite(grid, "stkde.pb")
    sync(dev)
    t3 = time.perf_counter()
    for name, s in (("entry", t1 - t0), ("scatter", t2 - t1),
                    ("finish", t3 - t2)):
        stages.setdefault(name, []).append(s)
    return grid
