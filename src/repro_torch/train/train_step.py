"""Train-step factory: CE loss (+ router aux, + z-loss), gradients by
``torch.autograd`` through the port's ``forward``, AdamW.

``make_train_step(cfg, opt_cfg)`` returns the reference's functional
contract ``(params, opt_state, batch) -> (params, opt_state, metrics)``:
new parameter and moment tensors are built, the inputs are not mutated, so
a caller that rejects a step (the runner's non-finite-loss skip) still
holds the old state. ``batch`` is a dict of tensors on the parameters'
device (``tokens``, ``labels``, optional ``mask``; ``vision_embeds`` /
``audio_frames`` for vlm / enc-dec configs).

The reference's ``remat`` (``jax.checkpoint`` per layer) saves memory
without changing a number; the port stores every layer's activations.
Matmuls in fp32 stay fp32: TF32 is left off (PyTorch's default), so the
card's loss stays comparable with the CPU's.
"""
from __future__ import annotations

import torch

from ..models import forward
from ..models.transformer import leaves, tree_map
from . import optimizer as opt

_F32 = torch.float32


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits fp32 (B, S, V)."""
    # the row max is a constant of the gradient (the reference's
    # stop_gradient)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    # the reference picks the label logit with a one-hot select-and-reduce
    # so that vocab-sharded logits are never gathered across devices; on one
    # device that sum of one value and zeros is this gather
    label_logit = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if mask is None:
        return nll.mean()
    mask = mask.to(_F32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def z_loss(logits, coef: float = 1e-4):
    """Stabilizes the softmax normalizer at scale (PaLM-style)."""
    z = torch.logsumexp(logits, dim=-1)
    return coef * torch.mean(torch.square(z))


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        kw = {}
        if cfg.frontend == "vision":
            kw["vision_embeds"] = batch["vision_embeds"]
        if cfg.enc_dec:
            kw["audio_frames"] = batch["audio_frames"]
        logits, aux = forward(cfg, params, batch["tokens"], **kw)
        # vlm: image prefix positions carry no labels
        logits = logits[:, -batch["tokens"].shape[1]:]
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = loss + aux + z_loss(logits)
        return total, {"ce": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((total, parts), grads)`` of ``loss_fn(params, batch)`` with
    respect to every parameter (zeros for one the loss does not reach, as
    ``jax.value_and_grad`` gives)."""
    with torch.enable_grad():
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        total, parts = loss_fn(p, batch)
        flat = torch.autograd.grad(total, list(leaves(p)),
                                   allow_unused=True, materialize_grads=True)
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    parts = {k: v.detach() for k, v in parts.items()}
    return (total.detach(), parts), grads


def make_train_step(cfg, opt_cfg: opt.OptimizerConfig):
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        (total, parts), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, metrics = opt.update(
            opt_cfg, params, grads, opt_state)
        metrics.update(parts, loss=total)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        total, parts = loss_fn(params, batch)
        return dict(parts, loss=total)

    return eval_step
