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
(``shard_train_state``), the batch split over the mesh's batch axes. Where
the batch is not split over "model" and a leaf's spec splits "model", a
config that ``models.transformer.tp_covers`` runs tensor-parallel inside
each batch shard, as GSPMD partitions the reference's step: each position
of the shard's row over "model" computes with its own pieces, gathered
over the batch axes only (Megatron's column / row splits, MLA's heads,
``E/M`` whole experts); the embedding, the head, the logits and the
cross-entropy are split by vocabulary. Every sharded step is ZeRO-3
(``_zero3_step``): a block gathers its own layer inside its checkpoint, and
backward cuts that layer's gradient into the pieces as it makes it.

The reference's ``remat`` (``jax.checkpoint`` per layer) is the port's
too: with ``cfg.remat`` (every full config) the forward checkpoints each
block (``models.transformer``), so backward holds the blocks' inputs and
one block's recompute, and not a number moves. Matmuls in fp32 stay fp32:
TF32 is left off (PyTorch's default), so the card's loss stays comparable
with the CPU's.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..distributed import collectives
from ..distributed import mesh as _mesh
from ..distributed import sharding as _sh
from ..models import forward, moe
from ..models.transformer import (STACKED, forward_tp, leaves, tp_covers,
                                  tree_map)
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
def shard_train_state(params, opt_state: opt.OptState, mesh, specs=None):
    """``(params, opt_state)`` placed for ``make_sharded_train_step``: the
    parameters and both moments cut into pieces by ``specs`` (default
    ``sharding.param_specs(params, mesh, fsdp=True)``; ``Sharded`` leaves),
    the step count on the mesh's first device. A mesh of one shard gives
    them back as they are."""
    if mesh.size == 1:
        return params, opt_state
    if specs is None:
        specs = _sh.param_specs(params, mesh, fsdp=True)
    return (_sh.shard_tree(params, specs, mesh),
            opt.OptState(mu=_sh.shard_tree(opt_state.mu, specs, mesh),
                         nu=_sh.shard_tree(opt_state.nu, specs, mesh),
                         step=opt_state.step.to(mesh.first_device)))


def _one_device_terms(cfg):
    """``(params, batch) -> (nll, z, aux, mask)`` of ``forward`` on one
    device: the per-token NLL, the ``logsumexp`` the z-loss squares, the
    aux loss and the batch's mask (or ``None``)."""
    def terms(params, batch):
        logits, aux = _logits(cfg, params, batch)
        return (_nll(logits, batch["labels"]),
                torch.logsumexp(logits, dim=-1), aux, batch.get("mask"))

    return terms


def _global_loss_fn(cfg, n_valid: torch.Tensor, n_tok: torch.Tensor,
                    terms=None):
    """A batch shard's loss with the terms normalised by the global batch's
    counts (CE by its valid positions, the z-loss by its tokens), so that
    the shards' losses, and their gradients, sum to the global ones. A
    MoE config's aux is zero here: under ``moe.global_dispatch`` the step
    adds the global one (``moe.global_aux``). ``terms`` gives the
    unnormalised terms (default ``_one_device_terms``; ``_tp_terms`` on a
    tensor-parallel row)."""
    terms = terms or _one_device_terms(cfg)

    def loss_fn(params, batch):
        nll, z, aux, mask = terms(params, batch)
        dev = _mesh.device_of(nll)
        ce_sum = (nll.sum() if mask is None
                  else (nll * mask.to(torch.float32)).sum())
        ce = ce_sum / n_valid.to(dev)
        zl = Z_LOSS_COEF * (torch.sum(torch.square(z)) / n_tok.to(dev))
        return ce + aux + zl, {"ce": ce, "aux": aux}

    return loss_fn


def _psum_list(vals) -> torch.Tensor:
    """The sum of per-shard tensors in list order, on the first's device."""
    return collectives.psum(collectives.shard_array(vals), 0).item()


def _next_dispatch(batch, disps, device, k: int) -> "moe.Dispatch":
    """Batch shard ``k``'s ``moe.Dispatch``: the global batch's token
    count, the slot offsets the earlier shards (``disps``) carried, on
    ``device``."""
    return moe.Dispatch(batch["labels"].numel(),
                        disps[-1].carried(device) if disps else (), shard=k)


def _global_backward(cfg, totals, disps, device):
    """The end of a MoE step on the global batch: the global load-balance
    loss (``moe.global_aux``, on ``device``) added to the shards' summed
    losses, and one backward through every shard's graph. Returns
    ``(total, aux)``."""
    aux = moe.global_aux(cfg, disps, device)
    total = _psum_list(totals) + aux
    total.backward()
    return total, aux


def vocab_parallel_nll(logits, labels):
    """The per-position NLL and ``logsumexp`` (the z-loss's ``z``) of
    vocabulary-split logits over the row of ``mesh.tp_row()``: position
    ``j`` holds logits (B, S, n) of ids ``[j n, (j + 1) n)`` and the labels
    (B, S). The reference's sharding-aware ``cross_entropy``: the row max
    by ``pmax`` (a constant of the gradient), the sums of the exponentials
    by ``psum``, the label logit by a one-hot select within each range and
    ``psum``; both results on the row's first position."""
    row = _mesh.tp_row()
    n = logits[0].shape[-1]
    m = collectives.pmax_row(_mesh.each(
        lambda lg: lg.amax(dim=-1).detach(), logits), row)
    shifted = _mesh.each(lambda lg, mj: lg - mj[..., None], logits, m)

    def label_logit(j, sh, lab):
        iota = torch.arange(n, device=sh.device)
        hit = iota == (lab.long() - j * n)[..., None]
        return torch.sum(torch.where(hit, sh, 0.0), dim=-1)

    lse = torch.log(_psum_list(_mesh.each(
        lambda sh: torch.sum(torch.exp(sh), dim=-1), shifted)))
    nll = lse - _psum_list(_mesh.each(label_logit, range(len(row)), shifted,
                                      labels))
    return nll, m[0] + lse


def _tp_terms(cfg):
    """``_one_device_terms`` over a tensor-parallel row: ``(per-position
    parameter trees, per-position batch dicts) -> (nll, z, aux, mask)`` on
    the row's first position, the NLL and ``z`` from
    ``vocab_parallel_nll``: no position holds the logits of the whole
    vocabulary. Logits left whole (a vocabulary that did not divide) give
    the one-device terms."""
    def terms(ps, parts):
        kw = {}
        if cfg.frontend == "vision":
            kw["vision_embeds"] = [b["vision_embeds"] for b in parts]
        if cfg.enc_dec:
            kw["audio_frames"] = [b["audio_frames"] for b in parts]
        T = parts[0]["tokens"].shape[1]
        logits, aux = forward_tp(cfg, ps, [b["tokens"] for b in parts],
                                 **kw)
        logits = [lg[:, -T:] for lg in logits]
        if logits[0].shape[-1] == cfg.vocab:
            nll = _nll(logits[0], parts[0]["labels"])
            z = torch.logsumexp(logits[0], dim=-1)
        else:
            nll, z = vocab_parallel_nll(logits,
                                        [b["labels"] for b in parts])
        return nll, z, aux, parts[0].get("mask")

    return terms


def row_pieces(params, row):
    """Each position's parameter tree on a tensor-parallel row: every
    ``Sharded`` leaf gathered over the batch axes onto the position, its
    "model" piece kept (``sharding.gather(..., index={"model": j})``)."""
    out = []
    for j, dev in enumerate(row):
        with _mesh.at(dev):
            out.append(tree_map(
                lambda p: _sh.gather(p, dev, index={_sh.TP: j}), params))
    return out


def row_value_and_grad(loss_fn, ps, parts):
    """``value_and_grad`` of a row's loss: ``((total, parts), one gradient
    tree per position)``. On ``row_pieces`` it is the gather-everything
    form that the tests hold the ZeRO-3 step against, bit for bit."""
    (total, out), g = value_and_grad(
        lambda t, b: loss_fn([t[j] for j in range(len(t))], b),
        dict(enumerate(ps)), parts)
    return (total, out), [g[j] for j in range(len(ps))]


def _tp_applies(cfg, mesh, params, batch_over_model: bool,
                serving: bool = False) -> bool:
    """Does the layout make the step tensor-parallel (GSPMD's choice)?
    ``serving``: the sharded prefill and decode, which ``tp_covers`` takes
    for more configs than the train step (the mamba2 and rwkv6 ones)."""
    return (not batch_over_model and tp_covers(cfg, serving)
            and mesh.shape.get(_sh.TP, 1) > 1
            and any(_sh.TP in p.spec.mesh_axes() for p in leaves(params)))


def _zero3_step(cfg, loss_fn, params, batch, grid, rows, tp: bool):
    """``((total, parts), Sharded gradients)`` of the sharded step, ZeRO-3:
    batch shard ``k`` runs on the positions ``grid[k]`` (with ``tp``, its
    row over "model", in ``tensor_parallel``, each position with its
    "model" pieces; else one position with whole leaves), on its rows of
    the batch. Its parameters come from ``sharding.Zero3``: the stacked
    blocks gathered over "data" a layer at a time inside each block (and
    again in its recompute under ``remat``), the other leaves gathered
    once for the shard; backward cuts each layer's gradient into the
    pieces as it makes it (``collectives.reduce_scatter_into``) and frees
    it, so no position holds every layer's weights or gradients at once.
    Without ``remat`` (``cfg.remat`` or ``scan_layers`` off), autograd
    keeps the weights a block's matmuls save until backward.

    A dense config runs each shard's backward before the next shard's
    forward, so each piece is the sum over the shards in row-major order
    (a leaf not split over "model" first summed over the row in order),
    bit for bit the per-shard sum. A MoE config (on a row, or on several
    shards) computes the reference's function on the global batch: each
    shard's forward under its ``moe.Dispatch`` (the global capacity, the
    slot offsets the earlier shards carried), then the global
    load-balance loss (``moe.global_aux``), then one backward through
    every shard's graph, which adds the shards' layers in the order
    autograd reaches them; with ``remat`` a block's recompute re-enters its
    row and its shard's dispatch."""
    z = _sh.Zero3(params, STACKED)
    disps = [] if cfg.mlp == "moe" and (tp or len(grid) > 1) else None
    totals, ces, auxs = [], [], []
    with torch.enable_grad():
        for k, row in enumerate(map(tuple, grid)):
            with _mesh.at(row[0]), (_mesh.tensor_parallel(row) if tp else
                                    contextlib.nullcontext()):
                parts = _mesh.each(lambda dev: {
                    name: v.narrow(0, k * rows, rows).to(dev)
                    for name, v in batch.items()}, row, over=row)
                ps = z.trees((dev, {_sh.TP: j} if tp else None)
                             for j, dev in enumerate(row))
                args = (ps, parts) if tp else (ps[0], parts[0])
                if disps is None:
                    total, p = loss_fn(*args)
                    total.backward()
                    total = total.detach()
                else:
                    d = _next_dispatch(batch, disps, row[0], k)
                    with moe.global_dispatch(d):
                        total, p = loss_fn(*args)
                    disps.append(d)
                del ps, args
            totals.append(total)
            ces.append(p["ce"].detach())
            auxs.append(p["aux"].detach())
        if disps is None:
            total, aux = _psum_list(totals), _psum_list(auxs)
        else:
            total, aux = _global_backward(cfg, totals, disps, grid[0][0])
    parts = {"ce": _psum_list(ces).detach(), "aux": aux.detach()}
    return (total.detach(), parts), z.grads()


def _tp_step(cfg, loss_fn, params, batch, mesh, axes, rows):
    """``_zero3_step`` of the tensor-parallel layout: each batch shard on
    its row of "model" positions."""
    grid = np.asarray(mesh.devices_of(tuple(axes) + (_sh.TP,)),
                      dtype=object).reshape(-1, mesh.shape[_sh.TP])
    return _zero3_step(cfg, loss_fn, params, batch, grid, rows, tp=True)


def make_sharded_value_and_grad(cfg, mesh, batch_over_model: bool = False):
    """``(params, batch) -> ((total, parts), grads)`` on a mesh: the global
    batch (a dict of whole tensors) split over ``sharding.batch_axes`` by
    ``data_specs``, each batch shard's loss terms normalised by the global
    counts, the shards' losses and gradients summed in row-major order; the
    gradients come back cut as the parameters are (``Sharded``).
    ``batch_over_model`` splits the batch over the model axis too
    (``data_specs(include_model=True)``: the reference's layout for an
    ``fsdp`` config).

    The layout decides the path, as it does for GSPMD. With the batch not
    split over "model", a leaf's spec splitting "model" and a config that
    ``tp_covers`` (attention, MLA or not, with a swiglu, gelu or MoE
    channel), each batch shard runs tensor-parallel over its row of
    positions (``_tp_step``): no position gathers a "model"-split leaf
    whole (an expert tensor, an MLA head-split leaf) or holds the whole
    vocabulary's logits. Otherwise each batch shard's forward and backward
    run on its device (the position at model index 0) with whole leaves.
    Either way the step is ZeRO-3 (``_zero3_step``): the blocks gather
    their layer over "data" inside their checkpoint and each layer's
    gradient is cut into the pieces as backward makes it.

    A MoE config on more than one batch shard computes the reference's
    GSPMD step, the one-device function on the global batch: expert
    capacity from the global token count, each (token, slot)'s place in
    its expert after the earlier shards' (``moe.global_dispatch``), the
    load-balance loss from global means. Its shards' (or rows') forwards
    run first and one backward follows (a tensor-parallel row runs under
    one dispatch in any case), so every shard's activations live until then:
    on separate cards each holds its own shard's, as GSPMD does; on one
    card holding every shard they add up to the one-device step's."""
    def vag(params, batch):
        spec = _sh.data_specs({"tokens": batch["tokens"]}, mesh,
                              include_model=batch_over_model)["tokens"]
        axes = _sh.P.axes_of(spec[0])
        devs = np.asarray(mesh.devices_of(axes), dtype=object).reshape(-1)
        dev0 = devs[0]
        labels, mask = batch["labels"], batch.get("mask")
        n_tok = torch.tensor(float(labels.numel()), device=dev0)
        n_valid = (n_tok if mask is None else torch.clamp(
            mask.to(torch.float32).sum(), min=1.0).to(dev0))
        rows = labels.shape[0] // len(devs)
        if _tp_applies(cfg, mesh, params, batch_over_model):
            return _tp_step(cfg, _global_loss_fn(cfg, n_valid, n_tok,
                                                 _tp_terms(cfg)),
                            params, batch, mesh, axes, rows)
        return _zero3_step(cfg, _global_loss_fn(cfg, n_valid, n_tok), params,
                           batch, devs.reshape(-1, 1), rows, tp=False)

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
    with _mesh.at(first):
        gnorm = torch.sqrt(_psum_list(sq).to(first))
        sc0 = opt.step_scalars(opt_cfg, gnorm, state.step)
    per_dev = {}

    def leaf(p, g, m, v):
        outs = [np.empty(p.pieces.shape, dtype=object) for _ in range(3)]
        for idx in np.ndindex(p.pieces.shape):
            dev = _mesh.device_of(p.pieces[idx])
            key = (dev, _mesh.position_of(dev))
            if key not in per_dev:
                per_dev[key] = sc0.to(dev)
            with _mesh.at(dev):
                new = opt.adamw_leaf(opt_cfg, per_dev[key], p.pieces[idx],
                                     g.pieces[idx], m.pieces[idx],
                                     v.pieces[idx], decay=p.ndim >= 2)
            for o, t in zip(outs, new):
                o[idx] = t
        return tuple(_sh.Sharded(o, p.spec, p.mesh, p.shape, dt)
                     for o, dt in zip(outs, (p.dtype, m.dtype, v.dtype)))

    out = tree_map(leaf, params, grads, state.mu, state.nu)

    def pick(i):
        return tree_map(lambda o: o[i], out)

    return (pick(0), opt.OptState(mu=pick(1), nu=pick(2), step=sc0.step),
            {"grad_norm": gnorm, "lr": sc0.lr})


def make_sharded_train_step(cfg, opt_cfg: opt.OptimizerConfig, mesh,
                            batch_over_model: bool = False):
    """The train step on a ``Mesh`` of shards, from one controller: the
    reference's GSPMD step (``jax.jit`` with ``param_specs(fsdp=True)`` and
    ``data_specs`` shardings) as explicit placement.

    Parameters and AdamW moments are ``Sharded`` leaves
    (``shard_train_state``). Gradients come from
    ``make_sharded_value_and_grad`` (each batch shard tensor-parallel over
    its row of positions, or on one device with whole layers, each layer
    gathered inside its block; each layer's gradient cut into the
    parameters' pieces as backward makes it), the update from
    ``sharded_update`` (each piece where it lives, one global norm). Same
    contract as ``make_train_step``: new tensors, inputs left alone.

    A mesh of one shard gives ``make_train_step`` itself. A MoE config on
    any mesh gives the reference's step on the global batch (global expert
    capacity and load-balance loss), and a config ``tp_covers`` (dbrx and
    deepseek included) on a "model" axis that does not carry the batch the
    tensor-parallel step (``make_sharded_value_and_grad``, as is
    ``batch_over_model``). Under ``sharding.hint_mesh`` a config with
    ``moe_impl="a2a"`` and no first dense layers (dbrx) runs the
    all-to-all inside each row (``moe.moe_apply_a2a_tp``)."""
    if mesh.size == 1:
        return make_train_step(cfg, opt_cfg)
    vag = make_sharded_value_and_grad(cfg, mesh, batch_over_model)

    def train_step(params, opt_state, batch):
        (total, parts), grads = vag(params, batch)
        params, opt_state, metrics = sharded_update(opt_cfg, params, grads,
                                                    opt_state)
        metrics.update(parts, loss=total)
        return params, opt_state, metrics

    return train_step
