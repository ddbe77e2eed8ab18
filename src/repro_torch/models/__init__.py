"""Language models of the port: the ten architectures' building blocks, in
plain PyTorch ops on parameter trees laid out as the reference's."""
from .config import ModelConfig
from . import layers, attention, mla, moe, ssm, rwkv, transformer, model
from .transformer import init_params, forward
from .model import DecodeState, init_decode_state, decode_step, prefill

__all__ = [
    "ModelConfig",
    "layers", "attention", "mla", "moe", "ssm", "rwkv", "transformer",
    "model", "init_params", "forward", "DecodeState", "init_decode_state",
    "decode_step", "prefill",
]
