"""Serving entry point: generation with the ServingEngine (slot-swap continuous
batching, the engine's default).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch smollm-360m --reduced --requests 8 --max-new 16

Runs on the card unless ``--device`` names another (``cpu``); weights come
from ``init_params(seed=0)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .._device import resolve_device
from ..configs import ARCHS, reduced as reduce_cfg
from ..models import init_params
from ..serve import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, the card)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dev = resolve_device(args.device)
    params = init_params(cfg, device=dev, seed=0)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch,
        max_seq=args.prompt_len + args.max_new + 8,
        temperature=args.temperature,
    ), device=dev)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        L = args.prompt_len - (uid % 3) * 4      # mixed-length buckets
        eng.submit(uid, rng.integers(0, cfg.vocab, L), max_new=args.max_new)
    t0 = time.perf_counter()
    out = eng.run()
    dt = time.perf_counter() - t0
    tok = sum(len(v) for v in out.values())
    print(f"[serve] {len(out)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s)")
    for uid in sorted(out)[:3]:
        print(f"  req {uid}: {out[uid][:10]}...")
    return out


if __name__ == "__main__":
    main()
