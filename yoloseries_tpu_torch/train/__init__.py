from .checkpoint import latest_step, restore_checkpoint, restore_weights, save_checkpoint
from .ema import ema_decay_weight, ema_update
from .optim import Optimizer, OptimizerConfig, build_optimizer, lr_schedule_factor
from .state import TrainState, create_train_state, make_train_step
from .trainer import Trainer

__all__ = ["Optimizer", "OptimizerConfig", "TrainState", "Trainer", "build_optimizer",
           "create_train_state", "ema_decay_weight", "ema_update", "latest_step",
           "lr_schedule_factor", "make_train_step", "restore_checkpoint", "restore_weights",
           "save_checkpoint"]
