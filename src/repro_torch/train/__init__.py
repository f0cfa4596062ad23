"""Training substrate: optimizer, schedules, train-step factory."""
from repro_torch.train.optimizer import (
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.train.train_step import make_train_step, TrainStepCfg

__all__ = [
    "OptState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "make_train_step",
    "TrainStepCfg",
]
