from .train_state import (TrainState, create_train_state, ema_effective_decay, ema_slice,
                          make_optimizer, update_emas)
from .train_step import (TrainStepConfig, make_eval_step, make_loss_fn, make_train_step,
                         train_step_config_from)
from .trainer import go_training

__all__ = ["TrainState", "TrainStepConfig", "create_train_state", "ema_effective_decay",
           "ema_slice", "go_training", "make_eval_step", "make_loss_fn", "make_optimizer",
           "make_train_step", "train_step_config_from", "update_emas"]
