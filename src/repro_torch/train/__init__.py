"""Training substrate of the port: optimizer, train step (one device, or a
mesh of shards), checkpointing, runner, and int8 gradient compression with
error feedback for a sum across pods (``grad_compress``; like the
reference's, no train step calls it)."""
from . import optimizer, train_step, checkpoint, runner, grad_compress
from .optimizer import OptimizerConfig
from .train_step import (
    make_train_step, make_eval_step, make_loss_fn, make_sharded_train_step,
    shard_train_state,
)
from .runner import TrainRunner, RunnerConfig
