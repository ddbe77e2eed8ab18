"""Train-step factory: CE loss (+ router aux, + z-loss), gradients by
``torch.autograd`` through the port's ``forward``, AdamW.

``make_train_step(cfg, opt_cfg)`` returns the reference's functional
contract ``(params, opt_state, batch) -> (params, opt_state, metrics)``:
new parameter and moment tensors are built, the inputs are not mutated, so
a caller that rejects a step (the runner's non-finite-loss skip) still
holds the old state. ``batch`` is a dict of tensors on the parameters'
device (``tokens``, ``labels``, optional ``mask``; ``vision_embeds`` /
``audio_frames`` for vlm / enc-dec configs).

``make_sharded_train_step(cfg, opt_cfg, mesh)`` is the same contract on a
``distributed.Mesh`` of shards (the reference's GSPMD step): parameters and
moments placed by ``sharding.param_specs(fsdp=True)``
(``shard_train_state``), the batch split over the mesh's batch axes.

The reference's ``remat`` (``jax.checkpoint`` per layer) saves memory
without changing a number; the port stores every layer's activations.
Matmuls in fp32 stay fp32: TF32 is left off (PyTorch's default), so the
card's loss stays comparable with the CPU's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import collectives
from ..distributed import sharding as _sh
from ..models import forward, moe
from ..models.transformer import leaves, tree_map
from . import optimizer as opt

_F32 = torch.float32


def _nll(logits, labels):
    """Per-position negative log-likelihood; logits fp32 (B, S, V)."""
    # the row max is a constant of the gradient (the reference's
    # stop_gradient)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    # the reference picks the label logit with a one-hot select-and-reduce
    # so that vocab-sharded logits are never gathered across devices; on one
    # device that sum of one value and zeros is this gather
    label_logit = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return lse - label_logit


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits fp32 (B, S, V)."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.to(_F32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


Z_LOSS_COEF = 1e-4


def z_loss(logits, coef: float = Z_LOSS_COEF):
    """Stabilizes the softmax normalizer at scale (PaLM-style)."""
    z = torch.logsumexp(logits, dim=-1)
    return coef * torch.mean(torch.square(z))


def _logits(cfg, params, batch):
    """Text-position logits and the MoE aux of ``forward`` on a batch."""
    kw = {}
    if cfg.frontend == "vision":
        kw["vision_embeds"] = batch["vision_embeds"]
    if cfg.enc_dec:
        kw["audio_frames"] = batch["audio_frames"]
    logits, aux = forward(cfg, params, batch["tokens"], **kw)
    # vlm: image prefix positions carry no labels
    return logits[:, -batch["tokens"].shape[1]:], aux


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        logits, aux = _logits(cfg, params, batch)
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


# ------------------------------------------------------------- on a mesh
def shard_train_state(params, opt_state: opt.OptState, mesh):
    """``(params, opt_state)`` placed for ``make_sharded_train_step``: the
    parameters and both moments cut into pieces by
    ``sharding.param_specs(params, mesh, fsdp=True)`` (``Sharded`` leaves),
    the step count on the mesh's first device. A mesh of one shard gives
    them back as they are."""
    if mesh.size == 1:
        return params, opt_state
    specs = _sh.param_specs(params, mesh, fsdp=True)
    return (_sh.shard_tree(params, specs, mesh),
            opt.OptState(mu=_sh.shard_tree(opt_state.mu, specs, mesh),
                         nu=_sh.shard_tree(opt_state.nu, specs, mesh),
                         step=opt_state.step.to(mesh.first_device)))


def _global_loss_fn(cfg, n_valid: torch.Tensor, n_tok: torch.Tensor):
    """A batch shard's loss with the terms normalised by the global batch's
    counts (CE by its valid positions, the z-loss by its tokens), so that
    the shards' losses, and their gradients, sum to the global ones. A
    MoE config's aux is zero here: under ``moe.global_dispatch`` the step
    adds the global one (``moe.global_aux``)."""
    def loss_fn(params, batch):
        logits, aux = _logits(cfg, params, batch)
        dev = logits.device
        nll = _nll(logits, batch["labels"])
        mask = batch.get("mask")
        ce_sum = (nll.sum() if mask is None
                  else (nll * mask.to(torch.float32)).sum())
        ce = ce_sum / n_valid.to(dev)
        z = torch.logsumexp(logits, dim=-1)
        zl = Z_LOSS_COEF * (torch.sum(torch.square(z)) / n_tok.to(dev))
        return ce + aux + zl, {"ce": ce, "aux": aux}

    return loss_fn


def _psum_list(vals) -> torch.Tensor:
    """The sum of per-shard tensors in list order, on the first's device."""
    return collectives.psum(collectives.shard_array(vals), 0).item()


def _moe_global_step(cfg, loss_fn, params, batch, devs, rows):
    """``((total, parts), per-shard gradient trees)`` of a MoE config over
    several batch shards: the reference's one-device function on the
    global batch. Each shard's forward runs on its device, in row-major
    order, under ``moe.global_dispatch`` with the offsets its predecessors
    carried, so capacity, keep masks and slots are the global batch's; the
    global load-balance loss is formed from every shard's router sums, and
    one backward runs through all the shards' graphs."""
    with torch.enable_grad():
        totals, ces, heres, disps = [], [], [], []
        for k, dev in enumerate(devs):
            part = {name: v.narrow(0, k * rows, rows).to(dev)
                    for name, v in batch.items()}
            here = tree_map(lambda p: _sh.gather(p, dev).detach()
                            .requires_grad_(True), params)
            d = moe.Dispatch(batch["labels"].numel(),
                             disps[-1].carried(dev) if disps else ())
            with moe.global_dispatch(d):
                total, parts = loss_fn(here, part)
            totals.append(total)
            ces.append(parts["ce"])
            heres.append(here)
            disps.append(d)
        aux = moe.global_aux(cfg, disps, devs[0])
        total = _psum_list(totals) + aux
        flat = torch.autograd.grad(
            total, [t for h in heres for t in leaves(h)], allow_unused=True,
            materialize_grads=True)
    it = iter(flat)
    grads = [tree_map(lambda _: next(it), params) for _ in heres]
    parts = {"ce": _psum_list(ces).detach(), "aux": aux.detach()}
    return (total.detach(), parts), grads


def make_sharded_value_and_grad(cfg, mesh):
    """``(params, batch) -> ((total, parts), grads)`` on a mesh: the global
    batch (a dict of whole tensors) split over ``sharding.batch_axes`` by
    ``data_specs``, each batch shard's forward and backward on its device
    with the ``Sharded`` parameters gathered there and its loss terms
    normalised by the global counts, the shards' losses and gradients summed
    in row-major order (``psum``); the gradients come back cut as the
    parameters are (``Sharded``).

    A MoE config on more than one batch shard computes the reference's
    GSPMD step, the one-device function on the global batch: expert
    capacity from the global token count, each (token, slot)'s place in
    its expert after the earlier shards' (``moe.global_dispatch``), the
    load-balance loss from global means. Its shards' forwards run first
    and one backward follows, so every shard's activations live until
    then: on separate cards each holds its own shard's, as GSPMD does; on
    one card holding every shard they add up to the one-device step's."""
    moe_global = cfg.mlp == "moe" and int(np.prod(
        [mesh.shape[a] for a in _sh.batch_axes(mesh)])) > 1

    def vag(params, batch):
        spec = _sh.data_specs({"tokens": batch["tokens"]}, mesh)["tokens"]
        axes = _sh.P.axes_of(spec[0])
        devs = np.asarray(mesh.devices_of(axes), dtype=object).reshape(-1)
        dev0 = devs[0]
        labels, mask = batch["labels"], batch.get("mask")
        n_tok = torch.tensor(float(labels.numel()), device=dev0)
        n_valid = (n_tok if mask is None else torch.clamp(
            mask.to(torch.float32).sum(), min=1.0).to(dev0))
        loss_fn = _global_loss_fn(cfg, n_valid, n_tok)
        rows = labels.shape[0] // len(devs)
        if moe_global:
            (total, parts), grads = _moe_global_step(
                cfg, loss_fn, params, batch, devs, rows)
        else:
            totals, ces, auxs, grads = [], [], [], []
            for k, dev in enumerate(devs):
                part = {name: v.narrow(0, k * rows, rows).to(dev)
                        for name, v in batch.items()}
                here = tree_map(lambda p: _sh.gather(p, dev), params)
                (total, parts), g = value_and_grad(loss_fn, here, part)
                totals.append(total)
                ces.append(parts["ce"])
                auxs.append(parts["aux"])
                grads.append(g)
                del here
            total = _psum_list(totals)
            parts = {"ce": _psum_list(ces), "aux": _psum_list(auxs)}
        full = tree_map(lambda *gs: _psum_list(gs), *grads)
        del grads
        pieces = tree_map(lambda p, g: _sh.shard(g, p.spec, p.mesh),
                          params, full)
        return (total, parts), pieces

    return vag


@torch.no_grad()
def sharded_update(opt_cfg: opt.OptimizerConfig, params, grads,
                   state: opt.OptState):
    """``optimizer.update`` on ``Sharded`` parameters, gradients and moments:
    one global norm (the pieces' squared sums added in a fixed order,
    leaves in sorted-key order, pieces row-major), then AdamW on each piece
    where it lives, weight decay by the leaf's rank."""
    first = next(leaves(params)).mesh.first_device
    sq = [torch.sum(torch.square(pc.to(torch.float32)))
          for g in opt.sorted_leaves(grads) for pc in g.pieces.flat]
    gnorm = torch.sqrt(_psum_list(sq).to(first))
    sc0 = opt.step_scalars(opt_cfg, gnorm, state.step)
    per_dev = {}

    def leaf(p, g, m, v):
        outs = [np.empty(p.pieces.shape, dtype=object) for _ in range(3)]
        for idx in np.ndindex(p.pieces.shape):
            dev = p.pieces[idx].device
            sc = per_dev.setdefault(dev, sc0.to(dev))
            new = opt.adamw_leaf(opt_cfg, sc, p.pieces[idx], g.pieces[idx],
                                 m.pieces[idx], v.pieces[idx],
                                 decay=p.ndim >= 2)
            for o, t in zip(outs, new):
                o[idx] = t
        return tuple(_sh.Sharded(o, p.spec, p.mesh, p.shape, dt)
                     for o, dt in zip(outs, (p.dtype, m.dtype, v.dtype)))

    out = tree_map(leaf, params, grads, state.mu, state.nu)

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return (pick(0), opt.OptState(mu=pick(1), nu=pick(2), step=sc0.step),
            {"grad_norm": gnorm, "lr": sc0.lr})


def make_sharded_train_step(cfg, opt_cfg: opt.OptimizerConfig, mesh):
    """The train step on a ``Mesh`` of shards, from one controller: the
    reference's GSPMD step (``jax.jit`` with ``param_specs(fsdp=True)`` and
    ``data_specs`` shardings) as explicit placement.

    Parameters and AdamW moments are ``Sharded`` leaves
    (``shard_train_state``). Gradients come from
    ``make_sharded_value_and_grad`` (batch shards on their devices, the
    parameters gathered there, the shards' gradients summed in row-major
    order and cut into the parameters' pieces), the update from
    ``sharded_update`` (each piece where it lives, one global norm). Same
    contract as ``make_train_step``: new tensors, inputs left alone.

    A mesh of one shard gives ``make_train_step`` itself. A MoE config on
    any mesh gives the reference's step on the global batch (global expert
    capacity and load-balance loss; ``make_sharded_value_and_grad``)."""
    if mesh.size == 1:
        return make_train_step(cfg, opt_cfg)
    vag = make_sharded_value_and_grad(cfg, mesh)

    def train_step(params, opt_state, batch):
        (total, parts), grads = vag(params, batch)
        params, opt_state, metrics = sharded_update(opt_cfg, params, grads,
                                                    opt_state)
        metrics.update(parts, loss=total)
        return params, opt_state, metrics

    return train_step
