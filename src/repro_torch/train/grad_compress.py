"""Int8 gradient compression with error feedback, for a gradient sum across
pods (the reference's ``train/grad_compress.py``).

Per-tensor-scaled int8 quantization cuts the bytes of a cross-pod gradient
sum 4x; the quantization residual is carried into the next step (error
feedback), which keeps SGD-style convergence (Seide et al. 2014; 1-bit Adam
lineage).

``quantize`` / ``dequantize`` / ``compress_tree`` work on one shard's
gradient tree (dicts of tensors). ``psum_compressed`` sums over an axis of
shards of one controller: each leaf of its ``grads`` is a numpy object
array of per-shard tensors (``distributed.collectives``' layout), and
``mesh_axis`` is the array axis that runs over the shards to sum. The
reference calls its version inside a ``shard_map``; its train step does not
call this module, and neither does the port's.

Quotients are true divisions by 0-dim tensors: on CUDA ``x / 127.0`` is a
multiplication by the reciprocal, which can put ``scale`` one ulp away
from the CPU's and flip ``round(g / scale)`` at .5. ``torch.round`` rounds
half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from ..distributed import collectives
from ..models.transformer import tree_map

_F32 = torch.float32


class CompressState(NamedTuple):
    error: Any     # residual tree (fp32), the structure of the grads


def init(grads) -> CompressState:
    """Zero residuals shaped as ``grads`` (a tree of tensors, or of object
    arrays of per-shard tensors)."""
    def zeros(g):
        if isinstance(g, np.ndarray):
            return _per_shard(lambda t: torch.zeros(t.shape, dtype=_F32,
                                                    device=t.device), g)
        return torch.zeros(g.shape, dtype=_F32, device=g.device)

    return CompressState(error=tree_map(zeros, grads))


def _per_shard(fn, *arrays) -> np.ndarray:
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return amax / torch.tensor(127.0, dtype=_F32, device=amax.device)


def _quantize_with(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    scale = _scale_of(torch.max(torch.abs(g)) + 1e-12)
    return _quantize_with(g, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def compress_tree(grads, state: CompressState):
    """Quantize grads + feedback; returns (q_tree, scales, new_state)."""
    fed = tree_map(lambda g, e: g.to(_F32) + e, grads, state.error)
    qs = tree_map(quantize, fed)
    q_tree = tree_map(lambda t: t[0], qs)
    scales = tree_map(lambda t: t[1], qs)
    new_err = tree_map(lambda f, q, s: f - dequantize(q, s), fed, q_tree,
                       scales)
    return q_tree, scales, CompressState(error=new_err)


def psum_compressed(grads, state: CompressState, mesh_axis: int):
    """Error-feedback-compressed sum over the shards along array axis
    ``mesh_axis`` of every leaf.

    (1) ``pmax`` agrees on one per-tensor scale (one scalar per tensor and
    shard on the wire), (2) every shard quantizes with the shared scale,
    (3) the int8 payloads are summed in int32 (``psum``, row-major), (4) the
    sum is dequantized once. Returns the dequantized sums (each leaf an
    object array without ``mesh_axis``, each sum on its group's first
    shard's device) and the shards' new residuals."""
    def leaf(g, e):
        fed = _per_shard(lambda a, b: a.to(_F32) + b, g, e)
        amax = _per_shard(lambda f: torch.max(torch.abs(f)) + 1e-12, fed)
        shared = collectives.pmax(amax, mesh_axis)
        # every shard reads the scale of its group
        scale = _broadcast(_per_shard(_scale_of, shared), fed, mesh_axis)
        q = _per_shard(_quantize_with, fed, scale)
        err = _per_shard(lambda f, qq, s: f - qq.to(_F32) * s, fed, q, scale)
        summed = collectives.psum(_per_shard(lambda qq: qq.to(torch.int32),
                                             q), mesh_axis)
        out = _per_shard(lambda qs, s: qs.to(_F32) * s.to(qs.device),
                         summed, _per_shard(_scale_of, shared))
        return out, err

    pairs = tree_map(leaf, grads, state.error)
    out = tree_map(lambda t: t[0], pairs)
    err = tree_map(lambda t: t[1], pairs)
    return out, CompressState(error=err)


def _broadcast(group_vals: np.ndarray, like: np.ndarray,
               mesh_axis: int) -> np.ndarray:
    """A value per group (``mesh_axis`` removed) to every shard of
    ``like``, on that shard's device."""
    out = np.empty(like.shape, dtype=object)
    for idx in np.ndindex(like.shape):
        gidx = idx[:mesh_axis] + idx[mesh_axis + 1:]
        out[idx] = group_vals[gidx].to(like[idx].device)
    return out
