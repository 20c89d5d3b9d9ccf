"""Train and eval steps of the AED SimOTA recipe and the epoch loop
(counterpart of frlw_evd_tpu/train/trainer.py: TrainState,
create_train_state, _compute_params, make_train_step, make_eval_step,
Trainer).

Mixed precision as in the JAX package: the model holds f32 master weights
and f32 BatchNorm statistics; with half_precision the step runs the
network on bf16 copies of the masters, made inside the differentiated
function (`torch.func.functional_call`), so every convolution computes in
bf16 and the gradients land on the f32 masters, which the optimiser
updates. (torch.autocast would keep f32 weights and cast per operation.)
The head maps are cast to f32 before the loss.

PyTorch runs eagerly, so there is no jit; a step updates its TrainState in
place and returns the loss tensors without a host sync. With remat the
differentiated forward runs under torch.utils.checkpoint (non-reentrant),
the counterpart of jax.checkpoint; with patchify the step space-to-depths
the volume once for a p64 stem. The yolov3, red and memory (convlstm /
recconv) families have their own steps (trainer.py:76-231): the yolov3
step takes gt_creator's anchor targets in place of labels, red's SSD
MultiBox step starts each batch from zero f32 carries, the memory steps
from None carries. `Trainer` runs the experiment over the blob datasets
for every family: epochs of train steps fed two batches ahead from pinned
host memory, per-epoch validation with COCO stats, the last and the best
checkpoint, resume and test.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..data import Loader, PropheseeDataset, PropheseeTafDataset
from ..evaluate import Evaluator, Recorder
from ..models.blocks import (BatchNorm2d, Dropout,
                             space_to_depth_patches)
from ..models.detector import (build_detector, build_memory_detector,
                               detector_loss, eval_decode, init_parameters_)
from ..models.postprocess import finalize_detections, postprocess_batch
from ..models.quantize import int8_ctx
from ..models import red
from ..parallel import dist
from ..parallel.multihost import broadcast_object, gather_objects
from ..models.yolov3 import (YOLOv3Detector, gt_creator, yolov3_eval_decode,
                             yolov3_loss)
from ..pipeline import channels_last_, resolve_device
from .checkpoints import (load_checkpoint, save_checkpoint,
                          save_part_checkpoints)
from .config import ExpConfig
from .ema import ema_init, ema_update
from .schedule import yolox_warm_cos_schedule


class Tx(NamedTuple):
    """An optimiser recipe, the port's optax.GradientTransformation: `make`
    builds the torch optimiser over (name, parameter) pairs, as
    model.named_parameters() gives them; `schedule`, when set, gives the
    lr of each update from the number of updates before it."""
    make: Callable[..., torch.optim.Optimizer]
    schedule: Optional[Callable[[int], float]] = None


def _lr(learning_rate) -> tuple[float, Optional[Callable[[int], float]]]:
    if callable(learning_rate):
        return learning_rate(0), learning_rate
    return float(learning_rate), None


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Tx:
    """optax.adam (eps_root 0): torch.optim.Adam computes the same update.
    learning_rate: a float or a schedule(step) -> float. The step is the
    multi-tensor (foreach) one, not the fused one: the fused step leaves
    the parameters' version counters as they were, which the kernel stems'
    weight cache reads (models/stem_chain.packed_weights). (Naming
    fused=False alone would select the per-tensor loop.)"""
    lr, schedule = _lr(learning_rate)
    return Tx(lambda named: torch.optim.Adam([p for _, p in named], lr=lr,
                                             betas=(b1, b2), eps=eps,
                                             foreach=True),
              schedule)


def sgd(learning_rate) -> Tx:
    """optax.sgd without momentum: p - lr * g, multi-tensor as adam's."""
    lr, schedule = _lr(learning_rate)
    return Tx(lambda named: torch.optim.SGD([p for _, p in named], lr=lr,
                                            foreach=True),
              schedule)


@dataclasses.dataclass
class TrainState:
    """The model (f32 masters and BatchNorm statistics), its optimiser,
    the lr schedule and the number of updates made (trainer.py:36-42)."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[Callable[[int], float]] = None

    def apply_gradients(self) -> None:
        """One optimiser update from the parameters' .grad: the lr is the
        schedule at the count of updates before this one (optax's
        scale_by_schedule), then the count rises by one."""
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, tx: Tx, *,
                       device="cuda") -> TrainState:
    """Move `model` to `device` in f32 (channels_last on the card), in
    training mode, and build its optimiser (trainer.py:45-56). The model
    comes initialised from build_detector's generator."""
    dev = resolve_device(device)
    model.to(device=dev, dtype=torch.float32).train()
    if dev.type == "cuda":
        channels_last_(model)
    return TrainState(0, model, tx.make(model.named_parameters()),
                      tx.schedule)


def _compute_params(params: dict[str, torch.Tensor],
                   half_precision: bool) -> dict[str, torch.Tensor]:
    """bf16 compute copies of the f32 masters (trainer.py:59-73), made
    with a differentiable cast so the gradients reach the masters; the
    masters themselves when not half_precision."""
    if not half_precision:
        return params
    return {k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for k, p in params.items()}


def _apply(model: nn.Module, half_precision: bool, *args):
    """model(*args) run on _compute_params."""
    params = _compute_params(dict(model.named_parameters()), half_precision)
    return functional_call(model, params, args)


def _forward(model: nn.Module, imgs, half_precision: bool):
    """The head maps in f32, the network run on _compute_params."""
    return [o.float() for o in _apply(model, half_precision, imgs)]


# the outputs remat_policy "dots" keeps, as jax.checkpoint_policies.
# checkpoint_dots keeps dot_general and conv_general_dilated outputs
_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(remat_policy, model, generator: torch.Generator):
    """context_fn for torch.utils.checkpoint: the forward runs as it is (or
    under the "dots" policy's caching mode); the recompute replays the
    forward's dropout masks and leaves the running statistics of `model`'s
    BatchNorms alone. checkpoint's preserve_rng_state restores the default
    generators only, so the dropout generator's state is taken when the
    forward starts, set back for the recompute and restored after it."""
    def context_fn():
        if remat_policy == "dots":
            forward_ctx, inner = create_selective_checkpoint_contexts(
                _save_dots)
        else:
            forward_ctx, inner = (contextlib.nullcontext(),
                                  contextlib.nullcontext())
        return forward_ctx, _replay(inner, model, generator,
                                    generator.get_state())
    return context_fn


@contextlib.contextmanager
def _stats_frozen(model):
    """`model`'s BatchNorms normalise without updating their running
    statistics inside (a flag on each module, which autograd's recompute
    thread sees)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_stats


@contextlib.contextmanager
def _replay(inner, model, generator: torch.Generator, forward_state):
    after = generator.get_state()
    generator.set_state(forward_state)
    try:
        with _stats_frozen(model), inner:
            yield
    finally:
        generator.set_state(after)


def make_train_step(strides, num_classes: int, radius: float,
                    half_precision: bool = False, *, remat: bool = False,
                    remat_policy: Optional[str] = None,
                    patchify: bool = False, device="cuda"):
    """Returns train_step(state, imgs, labels, generator) -> losses
    (trainer.py:234-288).

    imgs: (N, H, W, 2K) volumes; labels: (N, G, 5) f32 rows [class, cx,
    cy, w, h], zero rows padding; both are moved to the device. generator:
    a torch.Generator on the device for the stem's dropout masks. The step
    runs the model in training mode (batch statistics, running statistics
    updated, dropout), backpropagates total_loss to the f32 masters and
    updates them in place; it leaves the gradients in .grad and returns
    the dict of detached loss tensors.

    remat: the forward is recomputed in the backward (torch.utils.
    checkpoint, non-reentrant) instead of keeping its activations;
    remat_policy None recomputes all of it, "dots" keeps every conv and
    matmul output and recomputes the rest. The recompute reuses the
    forward's dropout masks and does not update the BatchNorm statistics
    again, so a remat step computes what the plain step does. One
    checkpoint spans the whole forward, as JAX's: the recompute holds all
    of its activations again as the backward starts, so the peak memory
    barely moves (gen1_train at batch 64 on an H100: 0.97x the plain
    step's peak at 1.4-1.8x its ms/step, chip_smoke.py phase 33). patchify:
    the volume is space-to-depth'd to (N, H/2, W/2, 4 * 2K) once, after
    the bf16 cast, for a model with a p64 stem (`bfm_p64`, `focus_p64`)."""
    if remat_policy not in (None, "dots"):
        raise ValueError(f"remat_policy must be None or 'dots', got "
                         f"{remat_policy!r}")

    def losses(model, imgs, labels, generator):
        if patchify:
            imgs = space_to_depth_patches(imgs)
        if remat:
            outs = checkpoint(_forward, model, imgs, half_precision,
                              use_reentrant=False,
                              context_fn=_remat_contexts(remat_policy, model,
                                                         generator))
        else:
            outs = _forward(model, imgs, half_precision)
        return detector_loss(outs, labels, strides, num_classes, radius)

    return _train_step(losses, half_precision, device)


# losses that are ratios of global counts, the same on every rank (the
# others are each rank's share of a global loss)
_GLOBAL_LOSSES = ("num_fg_per_gt",)


def _summed_over_ranks(losses: dict) -> dict:
    """The detached losses of the global batch: each share summed over
    the process group in one all-reduce (the losses themselves with no
    group)."""
    if not dist.initialized():
        return losses
    keys = [k for k in losses if k not in _GLOBAL_LOSSES]
    summed = dist.global_sum(torch.stack([losses[k] for k in keys]))
    return {k: summed[keys.index(k)] if k in keys else v
            for k, v in losses.items()}


def _train_step(losses_fn, half_precision: bool, device):
    """train_step(state, imgs, targets, generator) -> losses around
    losses_fn(model, imgs, targets, generator) -> the dict of losses: the
    model in training mode with the stem's dropout drawing from
    `generator`, imgs and targets moved to the device (imgs in bf16 under
    half_precision), total_loss backpropagated to the f32 masters, one
    optimiser update; the detached losses out.

    Under a process group (parallel/dist.py) imgs and targets are this
    rank's rows of the global batch, the losses its shares of the global
    batch's (normalised by global counts), and the masters' gradients are
    summed over the ranks in one bucket before the update, so every rank
    makes the one-process step's update of the global batch; the returned
    losses are the global ones. The step runs through functional_call on
    bf16 copies, so this is done here and not by DDP's module hooks."""
    dev = resolve_device(device)

    def train_step(state: TrainState, imgs, targets, generator):
        model = state.model.train()
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
        imgs = imgs.to(dev, torch.bfloat16 if half_precision else None)
        state.optimizer.zero_grad(set_to_none=True)
        losses = losses_fn(model, imgs, targets.to(dev), generator)
        losses["total_loss"].backward()
        dist.all_reduce_grads(model.parameters())
        state.apply_gradients()
        return _summed_over_ranks({k: v.detach() for k, v in losses.items()})

    return train_step


def make_eval_step(strides, max_detections: int = 200,
                   half_precision: bool = False, *, patchify: bool = False,
                   quant=None, device="cuda"):
    """Returns eval_step(state, imgs) -> (dets, keep) (trainer.py:291-315):
    the model in eval mode on _compute_params (the volume patchified first
    when `patchify`), f32 decode, then postprocess_batch with its defaults
    and `max_detections`. quant: an optional (act_scales, weight_table)
    pair (models/quantize.py's calibrate_int8 and build_weight_table); the
    forward then runs under int8_ctx, the calibrated sites through
    int8_conv2d (the kernel on the card, its twin on the CPU), the sites
    prepared from the model's weights at each call. On the card, whose
    kernel reads bf16, an f32 network's sites quantize their input rounded
    to bf16 (int8_ctx's act_dtype); on the CPU they quantize it in f32, as
    JAX does."""
    act_dtype = (torch.bfloat16 if resolve_device(device).type == "cuda"
                 and not half_precision else None)

    def decode(model, imgs):
        if patchify:
            imgs = space_to_depth_patches(imgs)
        if quant is None:
            return eval_decode(_forward(model, imgs, half_precision),
                               strides)
        with int8_ctx(model, *quant, act_dtype=act_dtype):
            return eval_decode(_forward(model, imgs, half_precision),
                               strides)

    return _eval_step(decode, functools.partial(
        postprocess_batch, max_detections=max_detections), half_precision,
        device)


def _eval_step(decode, select, half_precision: bool, device):
    """eval_step(state, imgs) -> select(decode(model, imgs)) without
    gradients, the model in eval mode, imgs on the device (bf16 under
    half_precision): decode gives the rows of every anchor or prior,
    select thresholds them and runs NMS. eval_step.decoded(state, imgs)
    returns the rows before select."""
    dev = resolve_device(device)

    @torch.no_grad()
    def decoded(state: TrainState, imgs):
        model = state.model.eval()
        return decode(model, imgs.to(dev, torch.bfloat16 if half_precision
                                     else None))

    def eval_step(state: TrainState, imgs):
        return select(decoded(state, imgs))

    eval_step.decoded = decoded
    return eval_step


def make_yolov3_train_step(num_classes: int, img_size: int,
                           half_precision: bool = False, *, device="cuda"):
    """The yolov3 family's step (trainer.py:76-105): train_step(state,
    imgs, gt_tensor, generator), gt_tensor gt_creator's (N, A, 7) anchor
    targets; the head maps in f32 into yolov3_loss."""
    def losses(model, imgs, gt_tensor, generator):
        return yolov3_loss(_forward(model, imgs, half_precision), gt_tensor,
                           num_classes, img_size)

    return _train_step(losses, half_precision, device)


def make_yolov3_eval_step(num_classes: int, img_size: int,
                          max_detections: int = 200,
                          half_precision: bool = False, *, device="cuda"):
    """(state, imgs) -> (dets, keep) (trainer.py:108-125): the f32 head
    maps through yolov3_eval_decode, then conf 0.3, NMS 0.5."""
    def decode(model, imgs):
        return yolov3_eval_decode(_forward(model, imgs, half_precision),
                                  num_classes, img_size)

    return _eval_step(decode, functools.partial(
        postprocess_batch, conf_threshold=0.3, nms_threshold=0.5,
        max_detections=max_detections), half_precision, device)


def _red_maps(model, imgs, height, width, half_precision):
    """RED on fresh zero f32 carries (train_memory_steps=1, as JAX's
    steps at trainer.py:143, :174): the f32 (cls_logits, bbox_pred)."""
    carries = model.init_carries(imgs.shape[0], height, width,
                                 device=imgs.device)
    _, (cls_logits, bbox_pred) = _apply(model, half_precision, carries, imgs)
    return cls_logits.float(), bbox_pred.float()


def make_red_train_step(height: int, width: int, priors,
                        half_precision: bool = False, *, device="cuda"):
    """The red family's step (trainer.py:128-161): the SSD MultiBox loss
    over build_priors' `priors`, labels (N, G, 5) as the SimOTA step's."""
    def losses(model, imgs, labels, generator):
        return red.red_loss(*_red_maps(model, imgs, height, width,
                                       half_precision),
                            labels, height, width, priors)

    return _train_step(losses, half_precision, device)


def make_red_eval_step(height: int, width: int, priors,
                       half_precision: bool = False, *, device="cuda"):
    """(state, imgs) -> (dets, keep) (trainer.py:164-185): fresh carries,
    red_eval_decode, then conf 0.01, NMS 0.45, 15 detections."""
    def decode(model, imgs):
        return red.red_eval_decode(
            *_red_maps(model, imgs, height, width, half_precision), priors,
            height, width)

    return _eval_step(decode, functools.partial(
        postprocess_batch, conf_threshold=red.CONFIDENCE_THRESHOLD,
        nms_threshold=red.NMS_THRESHOLD, max_detections=red.TOPK),
        half_precision, device)


def _memory_maps(model, imgs, half_precision):
    """A MemoryEventDetector from None carries: the f32 head maps."""
    _, outs = _apply(model, half_precision, None, imgs)
    return [o.float() for o in outs]


def make_memory_train_step(strides, num_classes: int, radius: float,
                           half_precision: bool = False, *, device="cuda"):
    """The convlstm / recconv step (trainer.py:188-212): None carries every
    batch, the SimOTA loss of the head maps."""
    def losses(model, imgs, labels, generator):
        return detector_loss(_memory_maps(model, imgs, half_precision),
                             labels, strides, num_classes, radius)

    return _train_step(losses, half_precision, device)


def make_memory_eval_step(strides, max_detections: int = 200,
                          half_precision: bool = False, *, device="cuda"):
    """(state, imgs) -> (dets, keep) (trainer.py:215-228): None carries,
    eval_decode, postprocess_batch's defaults."""
    def decode(model, imgs):
        return eval_decode(_memory_maps(model, imgs, half_precision),
                           strides)

    return _eval_step(decode, functools.partial(
        postprocess_batch, max_detections=max_detections), half_precision,
        device)


def _family_key(cfg: ExpConfig) -> str:
    """The row of _FAMILIES that builds cfg's model and steps."""
    if cfg.memory:
        return "memory"
    return cfg.family if cfg.family in ("yolov3", "red") else "detector"


def _yolov3_model(cfg: ExpConfig, generator) -> nn.Module:
    model = YOLOv3Detector(cfg.num_classes, cfg.input_channels,
                           use_bfm_stem=cfg.stem == "bfm", act=cfg.act)
    init_parameters_(model, generator)
    return model.train()


def _yolov3_steps(cfg: ExpConfig, half: bool, dev):
    size = cfg.img_size[0]
    return (make_yolov3_train_step(cfg.num_classes, size, half, device=dev),
            make_yolov3_eval_step(cfg.num_classes, size, half_precision=half,
                                  device=dev))


def _red_model(cfg: ExpConfig, generator) -> nn.Module:
    model = red.REDDetector(cfg.num_classes, cfg.input_channels)
    init_parameters_(model, generator)
    return model.train()


def _red_steps(cfg: ExpConfig, half: bool, dev):
    h, w = cfg.img_size
    priors = red.build_priors(h, w)
    return (make_red_train_step(h, w, priors, half, device=dev),
            make_red_eval_step(h, w, priors, half, device=dev))


def _memory_model(cfg: ExpConfig, generator) -> nn.Module:
    return build_memory_detector(
        cfg.num_classes, cfg.memory, stem=cfg.stem, act=cfg.act,
        strides=cfg.strides, in_channels=cfg.in_channels, depth=cfg.depth,
        input_channels=cfg.input_channels, generator=generator, train=True)


def _memory_steps(cfg: ExpConfig, half: bool, dev):
    return (make_memory_train_step(cfg.strides, cfg.num_classes,
                                   cfg.center_radius, half, device=dev),
            make_memory_eval_step(cfg.strides, half_precision=half,
                                  device=dev))


def _detector_model(cfg: ExpConfig, generator) -> nn.Module:
    stem = cfg.stem
    if cfg.patchified:
        patched = {"bfm": "bfm_p64", "focus": "focus_p64"}
        if stem not in patched:
            raise ValueError(f"patchified=True has no p64 variant of stem "
                             f"{stem!r}")
        stem = patched[stem]
    return build_detector(
        cfg.num_classes, family=cfg.family, stem=stem, act=cfg.act,
        strides=cfg.strides, in_channels=cfg.in_channels, depth=cfg.depth,
        input_channels=cfg.input_channels, generator=generator, train=True)


def _detector_steps(cfg: ExpConfig, half: bool, dev):
    return (make_train_step(cfg.strides, cfg.num_classes, cfg.center_radius,
                            half, remat=cfg.remat, patchify=cfg.patchified,
                            device=dev),
            make_eval_step(cfg.strides, half_precision=half,
                           patchify=cfg.patchified, device=dev))


# The model's builder (JAX trainer.py:329-357) and the steps' maker (JAX
# :445-470) of each family: aed / yolox are "detector", convlstm / recconv
# "memory".
_FAMILIES = {"yolov3": (_yolov3_model, _yolov3_steps),
             "red": (_red_model, _red_steps),
             "memory": (_memory_model, _memory_steps),
             "detector": (_detector_model, _detector_steps)}


class Trainer:
    """End-to-end experiment runner (trainer.py:318-645, reference
    basicExp) on `device` (default "cuda", which raises without a card).

    The model is the one of cfg's family, as JAX's Trainer builds it
    (trainer.py:329-357), its weights from torch seed cfg.seed:
    build_detector's for aed and yolox (stem, widths, input channels);
    YOLOv3Detector for yolov3, with the BFM stem when cfg.stem is "bfm"
    (yolov3_taf_bfm); REDDetector for red; build_memory_detector's
    MemoryEventDetector (hidden_dims cfg.in_channels, ReLU cells) for
    cfg.memory. With cfg.patchified the stem is its p64 variant (bfm →
    bfm_p64, focus → focus_p64) and both steps patchify the volume (aed
    and yolox only); cfg.remat makes the train step rematerialise its
    forward (full remat, as JAX's Trainer asks). A caller may replace
    `self.model` before `build`. The dropout masks come from a
    torch.Generator seeded cfg.seed + 1. Each `train_epoch` appends to
    `history` its epoch, per-step losses, wall seconds (ending in the host
    read of the losses), the seconds the loop waited for the next batch
    and, for yolov3, the host seconds of gt_creator within that wait;
    `_train_loop` adds the epoch's validation under "val" (the stats, the
    detection loop's and the COCO evaluation's seconds, also left in
    `last_eval` by each `eval_epoch`).

    Under a process group (`python -m torch.distributed.run
    --nproc_per_node=N -m frlw_evd_tpu_torch.cli.train ...`, parallel/
    dist.py) cfg.batch_size stays the global batch: every rank shuffles
    with the same seed and loads its contiguous rows of each global
    batch, the steps reduce over the group (BatchNorm statistics, loss
    normalisers, one gradient all-reduce), so every rank keeps the same
    parameters, optimiser and EMA; each rank decodes its rows of each
    validation batch and rank 0 evaluates them all (gather_objects) and
    alone writes checkpoints, TensorBoard and the epoch lines. Each rank's
    dataset draws its augmentation from seed cfg.seed + rank, so the
    ranks' draws are not alike."""

    def __init__(self, cfg: ExpConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        family = _family_key(cfg)
        if cfg.patchified and family != "detector":
            raise ValueError(
                "patchified=True is only wired for the single-window "
                "aed/yolox families (p64 stems)")
        build_model, _ = _FAMILIES[family]
        self.model = build_model(cfg,
                                 torch.Generator().manual_seed(cfg.seed))
        self.exp_dir = os.path.join(
            cfg.log_path, cfg.exp_name or cfg.resume_exp or cfg.exp_type)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # -1, so the first validation always writes best_epoch
        self.max_score = -1.0
        self.epoch = 0
        self.tb_writer = None
        self.ema_params = None
        self.history = []
        self.last_eval = None

    # -- data --------------------------------------------------------------
    def _make_dataset(self, mode: str, augment: bool):
        cfg = self.cfg
        # labels are rescaled sensor → input inside the dataset: the
        # override must reach it, or every box is mis-scaled silently
        sensor = cfg.sensor_hw_override
        seed = cfg.seed + dist.rank()
        if cfg.uses_taf_dataset:
            return PropheseeTafDataset(
                cfg.bbox_path, cfg.data_path, cfg.dataset, cfg.img_size,
                cfg.img_size, cfg.infer_time, cfg.event_volume_bins, mode,
                augment, cfg.clipping, seed=seed, sensor_hw=sensor)
        return PropheseeDataset(
            cfg.bbox_path, cfg.data_path, cfg.dataset, cfg.img_size,
            cfg.img_size, cfg.event_volume_bins, cfg.infer_time, mode,
            augment, cfg.clipping, seed=seed, sensor_hw=sensor)

    def _loader(self, dataset, train: bool) -> Loader:
        return Loader(dataset, self.cfg.batch_size, self.cfg.num_workers,
                      shuffle=train, drop_last=train,
                      seed=self.cfg.seed if train else 0,
                      pin_memory=self.device.type == "cuda",
                      shard=(dist.rank(), dist.world()))

    def create_datasets(self):
        cfg = self.cfg
        self.train_dataset = self._make_dataset("train", cfg.augmentation)
        self.val_dataset = self._make_dataset("val", False)
        self.train_loader = self._loader(self.train_dataset, True)
        self.val_loader = self._loader(self.val_dataset, False)
        self.object_classes = self.train_dataset.object_classes

    def create_test_dataset(self):
        self.val_dataset = self._make_dataset("test", False)
        self.val_loader = self._loader(self.val_dataset, False)
        self.object_classes = self.val_dataset.object_classes

    # -- setup -------------------------------------------------------------
    def build(self, iters_per_epoch: int):
        """Adam on the yolox warm-cos schedule over cfg.max_epoch epochs of
        `iters_per_epoch` steps, the train and eval steps, the dropout
        generator and, with cfg.use_ema, the EMA parameters."""
        cfg = self.cfg
        iters = max(iters_per_epoch, 1)
        self.schedule = yolox_warm_cos_schedule(
            cfg.init_lr, cfg.min_lr_ratio, cfg.max_epoch * iters,
            cfg.warmup_epochs * iters, cfg.warmup_lr)
        self.state = create_train_state(self.model, adam(self.schedule),
                                        device=self.device)
        _, make_steps = _FAMILIES[_family_key(cfg)]
        self.train_step, self.eval_step = make_steps(
            cfg, cfg.half_precision, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.ema_params = (ema_init(dict(self.model.named_parameters()))
                           if cfg.use_ema else None)
        n_params = sum(p.numel() for p in self.model.parameters())
        self._print(f"{n_params:,} total parameters.")

    @staticmethod
    def _print(msg: str) -> None:
        if dist.rank() == 0:
            print(msg)

    @contextlib.contextmanager
    def _eval_weights(self):
        """The model with the EMA parameters in place of the masters while
        inside, when kept (JAX evaluates and saves the best state with
        params=ema_params)."""
        if self.ema_params is None:
            yield
            return
        params = dict(self.model.named_parameters())
        masters = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self.ema_params[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(masters[k])

    # -- loops -------------------------------------------------------------
    def _prefetched_batches(self, lookahead: int = 2):
        """(imgs, targets) on the device, their copies dispatched
        `lookahead` batches ahead of the consuming step: the loader's
        batches are page-locked on the card, so each copy is
        non_blocking and the host goes on to the next batch. For yolov3
        the targets are gt_creator's anchor tensor, made on the host from
        the labels (trainer.py:494-503) into page-locked memory on the
        card; its seconds add up in self._gt_s."""
        cfg = self.cfg
        pin = self.device.type == "cuda"

        def put(item):
            imgs, labels = item[0], item[1]
            if cfg.family == "yolov3":
                t0 = time.perf_counter()
                labels = torch.from_numpy(gt_creator(
                    cfg.img_size[0], cfg.strides, labels.numpy()))
                if pin:
                    labels = labels.pin_memory()
                self._gt_s += time.perf_counter() - t0
            return (imgs.to(self.device, non_blocking=True),
                    labels.to(self.device, non_blocking=True))

        queue = collections.deque()
        for item in self.train_loader:
            queue.append(put(item))
            if len(queue) >= lookahead:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def train_epoch(self):
        """One pass over the train loader; returns the mean of each loss
        over its steps (one host read at the end) and prints it with the
        lr."""
        losses_acc = []
        wait = 0.0
        self._gt_s = 0.0
        t_epoch = time.perf_counter()
        batches = self._prefetched_batches()
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            losses = self.train_step(self.state, batch[0], batch[1],
                                     self.generator)
            if self.ema_params is not None:
                ema_update(self.ema_params,
                           dict(self.model.named_parameters()),
                           self.state.step)
            losses_acc.append(losses)
        if not losses_acc:
            return {}
        table = {k: torch.stack([lo[k] for lo in losses_acc]).double().cpu()
                 .numpy() for k in losses_acc[0]}
        self.history.append({
            "epoch": self.epoch,
            "losses": [{k: float(v[i]) for k, v in table.items()}
                       for i in range(len(losses_acc))],
            "steps": len(losses_acc),
            "wall_s": time.perf_counter() - t_epoch,
            "loader_wait_s": wait,
            **({"gt_creator_s": self._gt_s}
               if self.cfg.family == "yolov3" else {})})
        mean = {k: float(np.mean(v)) for k, v in table.items()}
        lr = float(self.schedule(self.state.step - 1))
        self._print(f"Epoch {self.epoch}: " +
                    ", ".join(f"{k}={v:.4f}" for k, v in mean.items()) +
                    f", lr={lr:.6f}")
        return mean

    def eval_epoch(self, evaluator: Evaluator):
        """Detections of the val loader (the EMA parameters when kept) into
        `evaluator`; returns its six COCO stats. Each batch's infer_time is
        read after a synchronize on the card. The last batch may be
        smaller: cudnn.benchmark is off in the port, so no autotuning
        reruns for it. Under a process group each rank decodes its rows of
        each batch, rank 0 gathers them in rank order (the one-process
        order), links and evaluates them, and every rank returns rank 0's
        stats."""
        t_loop = time.perf_counter()
        batches = []
        with self._eval_weights():
            for item in self.val_loader:
                if item is None:        # this rank holds no row of it
                    batches.append(None)
                    continue
                imgs, labels, names, tss = item
                start = time.time()
                dets, keep = self.eval_step(self.state, imgs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                infer_time = time.time() - start
                batches.append((finalize_detections(dets, keep), list(tss),
                                labels.numpy(), list(names), infer_time))
        if dist.world() > 1:
            batches = _merged_rank_batches(gather_objects(batches))
        if dist.rank() == 0:
            self._add_results(evaluator, batches)
        t_coco = time.perf_counter()
        stats = broadcast_object(evaluator.evaluate() if dist.rank() == 0
                                 else None)
        done = time.perf_counter()
        self.last_eval = {"stats": stats, "loop_s": t_coco - t_loop,
                          "coco_s": done - t_coco}
        return stats

    def _add_results(self, evaluator: Evaluator, batches) -> None:
        """Each batch's detections (seq-NMS-linked when cfg.seq_nms) into
        `evaluator`."""
        seq_state = None
        seq_stream = None
        if self.cfg.seq_nms:
            from ..models.seq_nms import SeqNMSState

            seq_state = SeqNMSState()
        for outputs, tss, labels, names, infer_time in batches:
            if seq_state is not None:
                # link detections across consecutive windows of each
                # stream (yolo_head.py:283-300; val samples arrive in
                # stream order)
                linked = []
                for out, name in zip(outputs, names):
                    if name != seq_stream:
                        seq_state.clean()
                        seq_stream = name
                    linked.append(seq_state.link(out))
                outputs = linked
            evaluator.add_result(outputs, tss, labels, names, infer_time,
                                 0.0)

    def make_evaluator(self, recorder=None) -> Evaluator:
        cfg = self.cfg
        return Evaluator(self.object_classes, cfg.batch_size, cfg.infer_time,
                         cfg.sensor_hw[1], cfg.sensor_hw[0],
                         cfg.img_size[1], cfg.img_size[0], cfg.dataset,
                         recorder)

    def _make_tb_writer(self):
        """TensorBoard scalars per epoch (Training/Loss, Validation/Map —
        reference core/exp.py:215,313,328) on rank 0; None elsewhere or if
        tensorboard is absent."""
        if dist.rank() != 0:
            return None
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(os.path.join(self.exp_dir, "tensorboard"))
        except Exception:
            return None

    def train(self):
        cfg = self.cfg
        self.create_datasets()
        self.build(len(self.train_loader))
        if cfg.resume_exp:
            path = os.path.join(cfg.log_path, cfg.resume_exp, "checkpoints",
                                "last_epoch")
            self.state, self.epoch, self.max_score = load_checkpoint(
                path, self.state, self.ema_params)
        self.tb_writer = self._make_tb_writer()
        try:
            self._train_loop()
        finally:
            if self.tb_writer is not None:
                self.tb_writer.close()

    def _train_loop(self):
        cfg = self.cfg
        while self.epoch < cfg.max_epoch_to_stop:
            mean = self.train_epoch()
            if self.tb_writer is not None and mean:
                self.tb_writer.add_scalar("Training/Loss",
                                          mean["total_loss"], self.epoch)
            if dist.rank() == 0:
                save_checkpoint(os.path.join(self.ckpt_dir, "last_epoch"),
                                self.state, self.epoch, self.max_score,
                                self.ema_params)
                save_part_checkpoints(
                    os.path.join(self.ckpt_dir, "last_epoch"), self.state)
            # reduce_evaluate: validate only every ~10% of the run and in
            # the final 40% (reference core/exp.py:249)
            do_eval = (not cfg.reduce_evaluate) or (
                self.epoch > 0
                and (self.epoch % math.ceil(cfg.max_epoch_to_stop / 10) == 0
                     or self.epoch >= cfg.max_epoch_to_stop / 5 * 3))
            if do_eval:
                result = self.eval_epoch(self.make_evaluator())
                if self.history and self.history[-1]["epoch"] == self.epoch:
                    self.history[-1]["val"] = self.last_eval
                if self.tb_writer is not None:
                    self.tb_writer.add_scalar("Validation/Map", result[0],
                                              self.epoch)
                if result[0] > self.max_score:
                    self.max_score = result[0]
                    if dist.rank() == 0:
                        with self._eval_weights():
                            save_checkpoint(
                                os.path.join(self.ckpt_dir, "best_epoch"),
                                self.state, self.epoch, self.max_score)
                self._print(f"Epoch {self.epoch}: best score "
                            f"{self.max_score}")
            if dist.initialized():      # the saves are on disk for all
                torch.distributed.barrier()
            self.epoch += 1

    def test(self):
        """The six COCO stats of the test split under the best_epoch
        checkpoint of cfg.resume_exp (or cfg.exp_type). That checkpoint
        holds the EMA parameters where they were kept, so they are not
        swapped in again (the JAX Trainer would evaluate fresh ones)."""
        cfg = self.cfg
        self.create_test_dataset()
        self.build(1)
        path = os.path.join(cfg.log_path, cfg.resume_exp or cfg.exp_type,
                            "checkpoints", "best_epoch")
        self.state, self.epoch, self.max_score = load_checkpoint(
            path, self.state)
        self.ema_params = None
        recorder = Recorder(self.exp_dir) if cfg.record else None
        return self.eval_epoch(self.make_evaluator(recorder))


def _merged_rank_batches(per_rank):
    """The ranks' validation batches (gather_objects of each rank's list,
    None where a rank held no row of a batch) as the one-process batches:
    each batch's rows in rank order, its infer_time the slowest rank's."""
    merged = []
    for parts in zip(*per_rank):
        parts = [p for p in parts if p is not None]
        merged.append((
            [o for p in parts for o in p[0]],
            [t for p in parts for t in p[1]],
            np.concatenate([p[2] for p in parts]),
            [n for p in parts for n in p[3]],
            max(p[4] for p in parts)))
    return merged
