"""Shape-only stand-ins for every (arch x shape) cell: the reference's
``launch/specs.py``, with tensors on ``torch.device("meta")`` in place of
``jax.ShapeDtypeStruct`` (a shape and a dtype, no storage).

Shape cells (LM transformers): train_4k / prefill_32k / decode_32k /
long_500k — see ``SHAPES``. ``decode_*`` / ``long_*`` stand for one decode
step (one token against a ``seq_len`` cache), not a train step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..models import model as model_lib
from ..models import transformer

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg, shape: ShapeCell) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "full-attention arch: 500k-context decode is skipped per "
            "assignment note (sub-quadratic archs only)"
        )
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_input_specs(cfg, shape: ShapeCell) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    extra = {}
    s_text = S
    if cfg.frontend == "vision":
        s_text = S - cfg.n_vision_tokens
        extra["vision_embeds"] = _sds(
            (B, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.enc_dec:
        extra["audio_frames"] = _sds((B, cfg.enc_seq, cfg.d_model),
                                     torch.bfloat16)
    return {
        "tokens": _sds((B, s_text), torch.int32),
        "labels": _sds((B, s_text), torch.int32),
        **extra,
    }


def prefill_input_specs(cfg, shape: ShapeCell) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((B, S), torch.int32)}
    if cfg.frontend == "vision":
        out["tokens"] = _sds((B, S - cfg.n_vision_tokens), torch.int32)
        out["vision_embeds"] = _sds(
            (B, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.enc_dec:
        out["audio_frames"] = _sds((B, cfg.enc_seq, cfg.d_model),
                                   torch.bfloat16)
    return out


def decode_input_specs(cfg, shape: ShapeCell) -> Dict[str, Any]:
    """Token + ``DecodeState`` stand-ins (cache sized ``seq_len``, bf16). The
    state is the port's: one cache per layer, batch first (the reference
    stacks them on a leading L axis)."""
    B, S = shape.global_batch, shape.seq_len
    state = model_lib.init_decode_state(cfg, B, S, torch.bfloat16,
                                        device=META)
    return {"token": _sds((B, 1), torch.int32), "state": state}


class _ShapeOnlyGenerator(torch.Generator):
    """A generator whose draws go to the meta device: ``init_params`` walks
    the init and makes every leaf with its shape and dtype, no values."""
    device = META


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


class _ShapeOnly(TorchFunctionMode):
    """The init's ops on meta tensors by their output's shape and dtype
    alone: an in-place op gives its input back, an out-of-place one an
    empty meta tensor of its result's shape (numpy broadcasts the shapes).
    PyTorch's meta versions of these ops (``trunc_normal_``'s ``clamp_``
    among them), and its ``broadcast_shapes``, are Python decompositions:
    seconds to import on first use, a millisecond a call."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.endswith("__") and getattr(
                args[0], "is_meta", False):
            return args[0]                  # in place: the shape stays
        if name in ("mul", "__mul__", "__rmul__"):
            return torch.empty(np.broadcast_shapes(*map(_shape, args)),
                               dtype=torch.result_type(*args), device=META)
        if name in ("log", "expm1"):
            return torch.empty_like(args[0])
        if name == "stack" and not kwargs.get("dim") and len(args) == 1:
            first = args[0][0]
            return torch.empty((len(args[0]),) + _shape(first),
                               dtype=first.dtype, device=META)
        if name in ("linspace", "randn"):
            shape = (args[2],) if name == "linspace" else args[0]
            return torch.empty(shape, device=META, dtype=kwargs.get(
                "dtype") or torch.get_default_dtype())
        return func(*args, **kwargs)


def param_specs_abstract(cfg) -> dict:
    """The parameter tree of ``cfg`` as meta tensors (no allocation): the
    tree, shapes and dtypes ``models.init_params`` gives."""
    with _ShapeOnly():
        return transformer.init_params(cfg, generator=_ShapeOnlyGenerator(),
                                       device=META)
