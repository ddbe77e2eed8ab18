"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch smollm-360m --reduced --steps 200 --batch 16 --seq 128 \
        --ckpt-dir /tmp/run1

Runs on the visible cards unless ``--device`` names another device
(``cpu``: one device). The reference's mesh: ``(n_dev // m, m)`` of
``("data", "model")`` with ``m = min(--model-axis, n_dev)``; on a mesh of
more than one device the parameters and AdamW moments are placed by
``sharding.param_specs(fsdp=True)`` and each step is
``make_sharded_train_step`` (batch over "data"; tensor-parallel over
"model" for a config of attention with a swiglu or gelu MLP, as GSPMD
runs the reference's step); on one device it is
``make_train_step``. Weights come from ``init_params(seed=0)``, batches
from ``SyntheticLM``, fault tolerance from ``train.runner`` (auto-resume
from ``--ckpt-dir``, async checkpoints every ``--ckpt-every`` steps, a
final checkpoint on SIGTERM or at the end; a sharded run's checkpoint
holds the gathered tree, in the reference's format).
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile

import numpy as np
import torch

from .._device import resolve_device
from ..configs import ARCHS, reduced as reduce_cfg
from ..data import DataConfig, SyntheticLM
from ..models import init_params
from ..distributed.mesh import Mesh
from ..train import (
    OptimizerConfig, RunnerConfig, TrainRunner, optimizer as opt_lib,
)
from ..train.train_step import make_sharded_train_step, shard_train_state


def train_mesh(device=None, model_axis: int = 1) -> Mesh:
    """The reference's training mesh: ``(n_dev // m, m)`` ``("data",
    "model")`` over the visible cards (``device=None`` or a CUDA device),
    or over the one ``device`` named otherwise, ``m = min(model_axis,
    n_dev)``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n_dev = len(devices)
    m = min(model_axis, n_dev)
    arr = np.empty(n_dev // m * m, dtype=object)
    arr[:] = devices[:n_dev // m * m]
    return Mesh(arr.reshape(n_dev // m, m), ("data", "model"))


def make_runner(argv=None, cfg=None):
    """The ``TrainRunner`` that ``main`` drives and its stream of batches
    on the run's device, from the command line ``argv``; ``cfg``, where
    given, replaces ``--arch``'s config (a published one cut in depth:
    ``ARCHS[arch].replace(n_layers=8)``). The runner has already resumed
    from ``--ckpt-dir`` when that holds a checkpoint; the stream starts at
    the runner's step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, the card)")
    args = ap.parse_args(argv)

    cfg = cfg or ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    mesh = train_mesh(args.device, args.model_axis)
    dev = mesh.first_device
    print(f"[train] arch={cfg.name} devices={mesh.size} "
          f"mesh={mesh.shape} device={dev} "
          f"params~{cfg.param_count() / 1e6:.1f}M")

    params = init_params(cfg, device=dev, seed=0)
    params, opt_state = shard_train_state(params, opt_lib.init(params), mesh)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                           total_steps=args.steps)
    step_fn = make_sharded_train_step(cfg, ocfg, mesh)
    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
    ))

    rcfg = RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        max_steps=args.steps)
    runner = TrainRunner(rcfg, step_fn, params, opt_state)

    def batches():
        s = runner.step
        while True:
            b = data.batch_at(s)
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            s += 1

    return runner, batches()


def main(argv=None, cfg=None):
    runner, batches = make_runner(argv, cfg)
    prev = signal.getsignal(signal.SIGTERM)
    runner.install_preemption_hook()
    try:
        summary = runner.run(batches)
    finally:
        signal.signal(signal.SIGTERM, prev)
    print(f"[train] done: {summary}")
    hist = runner.metrics_history
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}"
              f" over {len(hist)} steps")
    return summary


if __name__ == "__main__":
    main()
