"""Training substrate of the port: optimizer, train step, checkpointing,
runner (one device; gradient compression across pods is not here)."""
from . import optimizer, train_step, checkpoint, runner
from .optimizer import OptimizerConfig
from .train_step import make_train_step, make_eval_step, make_loss_fn
from .runner import TrainRunner, RunnerConfig
