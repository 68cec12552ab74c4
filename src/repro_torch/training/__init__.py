"""Training of the port: AdamW, the train loop and checkpoints
(``repro.training`` in PyTorch)."""
from .optimizer import (OptimizerConfig, AdamWState, adamw_update,
                        init_adamw, cosine_lr, clip_by_global_norm,
                        global_norm)
from .trainer import (TrainLog, TrainState, init_state, make_train_step,
                      train_loop, value_and_grad)
from . import checkpoint

__all__ = [
    "OptimizerConfig", "AdamWState", "adamw_update", "init_adamw",
    "cosine_lr", "clip_by_global_norm", "global_norm",
    "TrainLog", "TrainState", "make_train_step", "init_state", "train_loop",
    "value_and_grad", "checkpoint",
]
