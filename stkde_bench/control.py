#!/usr/bin/env python3
"""Readings that a cell's limit is set from, at the cell's own size.

    python3 stkde_bench/control.py --workload pollenus_hr.tile_mb \\
        --seeds 11,12,13 --control 3

For each seed it makes the cell's point sets as a run does, sends one real
query of the cell's traffic through the program and reads ``grid_err`` of
the grid that comes back (the program's reading); for the first
``--control`` seeds it also reads the control, the plain reference in TF32
put in the program's place. One JSON line per seed on standard output. The
benchmark's own runs do not run this; ``limits/<cell>.json`` keeps what it
read.
"""
import argparse
import json
import sys
import time

from run import _paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds of the program's readings")
    ap.add_argument("--control", type=int, default=3,
                    help="read the control on this many of the seeds")
    args = ap.parse_args(argv)
    _paths()
    import torch

    from stkde_bench import check, harness
    from stkde_bench.gen.events import point_sets

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    doms = harness.domains(cell)
    devs = harness.devices(cell.chips)
    dev = devs[0]
    run = harness.caller(cell.traffic, devs)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        sets = point_sets(cell.config, seed, cell.traffic["point_sets"])
        k = i % len(sets)
        dom, box = doms[i % len(doms)]
        grid = run(sets[k], dom)
        harness.sync(*devs)
        t0 = time.perf_counter()
        err = check.grid_err(check.of_grid(grid), sets[k], box, dev)
        ref_s = time.perf_counter() - t0
        del grid
        line = {"workload": args.workload, "seed": seed, "set": k,
                "program_grid_err": err, "reference_s": ref_s,
                "limit": cell.limits["grid_err"]}
        if i < args.control:
            torch.cuda.empty_cache()
            line["control_grid_err"] = check.grid_err(
                check.control(box, len(sets[k])), sets[k], box, dev)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
