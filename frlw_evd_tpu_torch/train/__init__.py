"""Training of the port (counterpart of frlw_evd_tpu/train): the SimOTA
train and eval steps of the aed and yolox families with f32 master
weights and bf16 compute (remat and patchify included), the steps of the
yolov3, red and memory (convlstm / recconv) families, the epoch loop
(`Trainer`), the learning-rate schedules, the EMA, the experiment config,
.pth checkpoints, the reference .pth import and the backbone freeze."""

from .checkpoints import (default_rename, freeze_backbone_tx,
                          import_torch_checkpoint, load_checkpoint,
                          load_pretrained_backbone, save_checkpoint,
                          save_part_checkpoints)
from .config import EXP_TYPES, ExpConfig, make_config
from .ema import ema_init, ema_update
from .schedule import (cos_schedule, multistep_schedule, warm_cos_schedule,
                       yolox_warm_cos_schedule)
from .synthetic import TRAIN_CONFIGS, run_train, synthetic_batches
from .trainer import (Trainer, TrainState, Tx, adam, create_train_state,
                      make_eval_step, make_memory_eval_step,
                      make_memory_train_step, make_red_eval_step,
                      make_red_train_step, make_train_step,
                      make_yolov3_eval_step, make_yolov3_train_step, sgd)

__all__ = ["EXP_TYPES", "ExpConfig", "TRAIN_CONFIGS", "TrainState",
           "Trainer", "Tx", "adam", "cos_schedule", "create_train_state",
           "default_rename", "ema_init", "ema_update", "freeze_backbone_tx",
           "import_torch_checkpoint", "load_checkpoint",
           "load_pretrained_backbone", "make_config", "make_eval_step",
           "make_memory_eval_step", "make_memory_train_step",
           "make_red_eval_step", "make_red_train_step", "make_train_step",
           "make_yolov3_eval_step", "make_yolov3_train_step",
           "multistep_schedule", "run_train",
           "save_checkpoint", "save_part_checkpoints", "sgd",
           "synthetic_batches", "warm_cos_schedule",
           "yolox_warm_cos_schedule"]
