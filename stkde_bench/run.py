#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process sees.

    python3 stkde_bench/run.py --workload pollenus_hr.tile_mb --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout (``PYTHONPATH=src python -m stkde_bench.run``
does the same). It measures the PyTorch and CUDA port, ``repro_torch``
under ``src/``, and prints the result as one JSON line, last on standard
output; the numbers the correctness check compared, each beside its limit,
are the last lines of standard error and the last key of that line. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. It exits with a code other than 0, and
prints no result, without a CUDA device (or fewer than the cell asks for),
without the port beside it, or when the run has loaded JAX or the JAX
package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _paths() -> None:
    """The checkout's root (for ``stkde_bench``) and ``src/`` (for the
    port) on the import path; not the folder of this file."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _finite(x):
    """``x`` with every non-finite float written as its repr (strict JSON
    has no infinity)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return repr(x) if isinstance(x, float) and not math.isfinite(x) else x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    os.environ.setdefault("USE_FLAX", "0")

    from stkde_bench import harness

    cell = harness.load_cell(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result.get("staged_check", {}).items():
        print(f"staged {name} {c!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
