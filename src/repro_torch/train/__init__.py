"""Training and serving steps over the model: AdamW with float32 masters,
the microbatched train step, checkpoints and the trainer with SkewShield
expert placement (the JAX package's ``repro.train``)."""

from .checkpoint import CheckpointManager
from .optimizer import (OptConfig, global_norm, opt_init, opt_shardings,
                        opt_update, schedule)
from .train_step import make_serve_step, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "OptConfig", "global_norm", "opt_init",
           "opt_shardings", "opt_update", "schedule", "make_serve_step", "make_train_step",
           "Trainer", "TrainerConfig"]
