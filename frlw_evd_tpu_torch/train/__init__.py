"""Training of the port (counterpart of frlw_evd_tpu/train): the AED SimOTA
train and eval steps with f32 master weights and bf16 compute, the
learning-rate schedules, the EMA, the experiment config and .pth
checkpoints."""

from .checkpoints import load_checkpoint, save_checkpoint
from .config import EXP_TYPES, ExpConfig, make_config
from .ema import ema_init, ema_update
from .schedule import (cos_schedule, multistep_schedule, warm_cos_schedule,
                       yolox_warm_cos_schedule)
from .synthetic import TRAIN_CONFIGS, run_train, synthetic_batches
from .trainer import (TrainState, Tx, adam, create_train_state,
                      make_eval_step, make_train_step, sgd)

__all__ = ["EXP_TYPES", "ExpConfig", "TRAIN_CONFIGS", "TrainState", "Tx",
           "adam", "cos_schedule", "create_train_state",
           "ema_init", "ema_update", "load_checkpoint", "make_config",
           "make_eval_step", "make_train_step", "multistep_schedule",
           "run_train", "save_checkpoint", "sgd", "synthetic_batches",
           "warm_cos_schedule", "yolox_warm_cos_schedule"]
