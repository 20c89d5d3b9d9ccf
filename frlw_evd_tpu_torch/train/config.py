"""Structured experiment configuration (a copy of
frlw_evd_tpu/train/config.py, kept here so the port imports nothing of the
JAX package).

Replaces the reference's flat Settings objects + hard-coded exp-type if/elif
dispatch (settings.py, train.py:37-70) with one dataclass, while keeping the
same recipe surface: exp types, dataset geometry, LR law, epochs. The
port's Trainer builds every family here but the experimental stems
(taf_swin, taf_corr, taf_syn); the JAX-only fields (data_axis, rng_impl)
are kept so that one config reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class ExpConfig:
    # experiment identity
    exp_type: str = "basic"
    dataset: str = "gen1"              # gen1 | gen4 | kitti
    exp_name: Optional[str] = None

    # data
    data_path: str = ""
    bbox_path: str = ""
    event_volume_bins: int = 5
    infer_time: int = 10000            # µs per detection window
    augmentation: bool = True
    clipping: bool = False

    # model (derived from exp_type by make_config)
    family: str = "aed"                # aed | yolox | yolov3 | red
    stem: str = "focus"                # focus | taf | bfm
    memory: Optional[str] = None       # None | convlstm | convgru
    seq_nms: bool = False
    act: str = "silu"
    strides: Tuple[int, ...] = (8, 16, 32)
    in_channels: Tuple[int, ...] = (256, 256, 256)
    depth: float = 0.33

    # optimisation (settings.py:80-94)
    batch_size: int = 64
    max_epoch: int = 50
    max_epoch_to_stop: int = 35
    warmup_epochs: int = 5
    base_lr_per_64: float = 0.0133333  # init_lr = base/64 * batch (linear law)
    warmup_lr: float = 0.0
    min_lr_ratio: float = 0.05
    seed: int = 0

    # runtime
    num_workers: int = 4
    log_path: str = "log/"
    resume_exp: Optional[str] = None
    record: bool = False
    reduce_evaluate: bool = False
    data_axis: str = "data"            # mesh axis for data parallelism
    half_precision: bool = True        # bfloat16 activations on TPU
    use_ema: bool = False              # eval/best-checkpoint use EMA params
                                       # (ModelEMA exists but is unused in
                                       # the reference trainer; opt-in here)
    remat: bool = False                # checkpoint the whole forward pass,
                                       # as JAX's jax.checkpoint: recompute
                                       # FLOPs, but no peak memory saved
                                       # on the card (chip_smoke phase 33)
    patchified: bool = False           # route train/eval through the
                                       # quarter-res p64 stem (identical
                                       # params/math; the full-res C-minor
                                       # tensors never exist — see
                                       # trainer.make_train_step)
    rng_impl: str = "threefry2x32"     # dropout PRNG impl: 'threefry2x32'
                                       # (default, cross-platform bits) or
                                       # 'rbg' (TPU hardware bit generator —
                                       # much cheaper mask generation)

    # geometry overrides (None → dataset defaults); used by tests/mini sets
    img_size_override: Optional[Tuple[int, int]] = None
    sensor_hw_override: Optional[Tuple[int, int]] = None

    # -- derived -----------------------------------------------------------
    @property
    def img_size(self) -> Tuple[int, int]:
        if self.img_size_override is not None:
            return self.img_size_override
        if self.dataset == "gen1":
            return (256, 320)
        if self.dataset == "gen4":
            return (512, 640)
        return (192, 640)

    @property
    def sensor_hw(self) -> Tuple[int, int]:
        if self.sensor_hw_override is not None:
            return self.sensor_hw_override
        if self.dataset == "gen1":
            return (240, 304)
        if self.dataset == "kitti":
            return (375, 1242)
        return (720, 1280)

    @property
    def num_classes(self) -> int:
        return 2 if self.dataset in ("gen1", "kitti") else 7

    @property
    def center_radius(self) -> float:
        # core/exp.py:378-384
        return 5.0 if self.dataset == "gen1" else 2.5

    @property
    def init_lr(self) -> float:
        return self.base_lr_per_64 / 64.0 * self.batch_size

    @property
    def input_channels(self) -> int:
        if self.uses_taf_dataset and self.event_volume_bins > 4:
            return 2 * self.event_volume_bins  # bins{K/2}+bins{K} concat
        return 2 * self.event_volume_bins

    @property
    def uses_taf_dataset(self) -> bool:
        return self.exp_type in ("taf", "taf_bfm", "yolov3_taf_bfm",
                                 "yolox_taf_bfm", "taf_swin", "taf_corr",
                                 "taf_syn")


# exp-type → (family, stem, uses_taf_dataset) — README table :106-142,
# core/exp.py subclasses.
EXP_TYPES = {
    "basic": dict(family="aed", stem="focus"),
    "taf": dict(family="aed", stem="focus"),
    "taf_bfm": dict(family="aed", stem="bfm"),
    "yolox": dict(family="yolox", stem="focus"),
    "yolox_taf_bfm": dict(family="yolox", stem="bfm"),
    "yolov3": dict(family="yolov3", stem="focus"),
    "yolov3_taf_bfm": dict(family="yolov3", stem="bfm"),
    # recurrent families (unwired in the reference; first-class here)
    "red": dict(family="red", stem="focus"),
    "convlstm": dict(family="aed", stem="focus", memory="convlstm"),
    "recconv": dict(family="aed", stem="focus", memory="convgru"),
    "seqnms": dict(family="aed", stem="focus", seq_nms=True),
    # experimental TAF stems (commented exp classes in the reference)
    "taf_swin": dict(family="aed", stem="taf_swin"),
    "taf_corr": dict(family="aed", stem="taf_corr"),
    "taf_syn": dict(family="swin_darknet", stem="focus"),
}


def make_config(exp_type: str, **overrides) -> ExpConfig:
    if exp_type not in EXP_TYPES:
        raise ValueError(f"unknown exp_type {exp_type!r}; "
                         f"choose from {sorted(EXP_TYPES)}")
    spec = dict(EXP_TYPES[exp_type])
    cfg = ExpConfig(exp_type=exp_type, **spec, **overrides)
    if cfg.dataset == "gen4":
        cfg.max_epoch_to_stop = 50
    if cfg.family == "yolov3" and cfg.img_size_override is None:
        # the yolov3 exp trains at 640x640 with box clipping
        # (reference train.py:44-66, head.py img_size=640)
        cfg.img_size_override = (640, 640)
        cfg.clipping = True
    return cfg
