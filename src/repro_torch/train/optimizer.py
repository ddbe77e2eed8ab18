"""AdamW optimizer + LR schedule + global-norm clipping, as plain functions
on the port's parameter trees (nested dicts of tensors), with the
reference's arithmetic.

No ``torch.optim``: the train step is the functional contract
``(params, opt_state, batch) -> (new_params, new_opt_state, metrics)``,
which the runner's non-finite-loss skip relies on (it keeps the old
tensors), and ``OptState``'s field names are the checkpoint's keys, shared
with the reference. Moments are fp32 whatever the parameters' dtype; every
update builds new tensors and mutates none.

Scalars stay on the device as 0-dim fp32 tensors, and every quotient is a
true division by a tensor: PyTorch turns ``x / python_scalar`` on CUDA, and
``python_scalar / x`` everywhere, into a multiplication by a reciprocal,
which rounds otherwise than the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..models.transformer import leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Any                 # fp32 first moments, the parameters' tree
    nu: Any                 # fp32 second moments
    step: torch.Tensor      # 0-dim int32: updates taken


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32, device=device)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (0-dim fp32, on the
    device of ``step`` when it is a tensor)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).to(_F32)
    warm = cfg.lr * step / _f32(max(1.0, cfg.warmup_steps), dev)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(1.0, cfg.total_steps - cfg.warmup_steps), dev),
        0.0, 1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                           device=p.device), params)
    dev = next(leaves(params)).device
    return OptState(mu=zeros, nu=tree_map(torch.clone, zeros),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def sorted_leaves(tree):
    """The tensors of a tree in sorted-key order: the reference's leaf order
    (``jax.tree.leaves`` sorts dict keys), so sums over leaves add in the
    same order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k])
    else:
        yield tree


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                          for g in sorted_leaves(tree)))


class StepScalars(NamedTuple):
    """What every leaf's update reads: the clip scale, the new step count,
    its learning rate and the two bias corrections (0-dim, one device)."""
    scale: torch.Tensor
    step: torch.Tensor
    lr: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor

    def to(self, device) -> "StepScalars":
        return StepScalars(*(t.to(device) for t in self))


def step_scalars(cfg: OptimizerConfig, gnorm: torch.Tensor,
                 state_step: torch.Tensor) -> StepScalars:
    dev = gnorm.device
    scale = torch.clamp(_f32(cfg.clip_norm, dev)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state_step.to(dev) + 1
    lr = lr_at(cfg, step)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), step.to(_F32))
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), step.to(_F32))
    return StepScalars(scale, step, lr, bc1, bc2)


def adamw_leaf(cfg: OptimizerConfig, sc: StepScalars, p, g, m, v,
               decay: bool):
    """AdamW on one tensor (a whole leaf, or a piece of one): new
    (parameter, first moment, second moment). ``decay`` says whether the
    leaf is a matrix (weight decay applies) or a norm / bias."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.to(_F32) * sc.scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    upd = (m / sc.bc1) / (torch.sqrt(v / sc.bc2) + cfg.eps)
    wd = cfg.weight_decay if decay else 0.0
    new_p = p.to(_F32) - sc.lr * (upd + wd * p.to(_F32))
    return new_p.to(p.dtype), m, v


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads,
           state: OptState) -> Tuple[Any, OptState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are left as they are."""
    gnorm = global_norm(grads)
    sc = step_scalars(cfg, gnorm, state.step)
    step, lr = sc.step, sc.lr

    def leaf(p, g, m, v):
        return adamw_leaf(cfg, sc, p, g, m, v, decay=p.ndim >= 2)

    out = tree_map(leaf, params, grads, state.mu, state.nu)

    def pick(i):
        return tree_map(lambda o: o[i], out)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), OptState(mu=pick(1), nu=pick(2), step=step), metrics
