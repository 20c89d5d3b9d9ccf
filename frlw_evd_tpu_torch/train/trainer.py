"""Train and eval steps of the AED SimOTA recipe (counterpart of
frlw_evd_tpu/train/trainer.py: TrainState, create_train_state,
_compute_params, make_train_step, make_eval_step).

Mixed precision as in the JAX package: the model holds f32 master weights
and f32 BatchNorm statistics; with half_precision the step runs the
network on bf16 copies of the masters, made inside the differentiated
function (`torch.func.functional_call`), so every convolution computes in
bf16 and the gradients land on the f32 masters, which the optimiser
updates. (torch.autocast would keep f32 weights and cast per operation.)
The head maps are cast to f32 before the loss.

PyTorch runs eagerly, so there is no jit; a step updates its TrainState in
place and returns the loss tensors without a host sync. The epoch loop
(`Trainer`) waits for the dataset, loader and evaluator ports; so do
`remat` and `patchify`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call

from ..models.detector import EventDetector, detector_loss, eval_decode
from ..models.postprocess import postprocess_batch
from ..models.stems import Dropout
from ..pipeline import resolve_device


class Tx(NamedTuple):
    """An optimiser recipe, the port's optax.GradientTransformation: `make`
    builds the torch optimiser over the parameters; `schedule`, when set,
    gives the lr of each update from the number of updates before it."""
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
    return Tx(lambda params: torch.optim.Adam(params, lr=lr, betas=(b1, b2),
                                              eps=eps, foreach=True),
              schedule)


def sgd(learning_rate) -> Tx:
    """optax.sgd without momentum: p - lr * g, multi-tensor as adam's."""
    lr, schedule = _lr(learning_rate)
    return Tx(lambda params: torch.optim.SGD(params, lr=lr, foreach=True),
              schedule)


@dataclasses.dataclass
class TrainState:
    """The model (f32 masters and BatchNorm statistics), its optimiser,
    the lr schedule and the number of updates made (trainer.py:36-42)."""
    step: int
    model: EventDetector
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


def create_train_state(model: EventDetector, tx: Tx, *,
                       device="cuda") -> TrainState:
    """Move `model` to `device` in f32 (channels_last on the card), in
    training mode, and build its optimiser (trainer.py:45-56). The model
    comes initialised from build_detector's generator."""
    dev = resolve_device(device)
    model.to(device=dev, dtype=torch.float32).train()
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return TrainState(0, model, tx.make(model.parameters()), tx.schedule)


def _compute_params(params: dict[str, torch.Tensor],
                   half_precision: bool) -> dict[str, torch.Tensor]:
    """bf16 compute copies of the f32 masters (trainer.py:59-73), made
    with a differentiable cast so the gradients reach the masters; the
    masters themselves when not half_precision."""
    if not half_precision:
        return params
    return {k: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for k, p in params.items()}


def _forward(model: EventDetector, imgs, half_precision: bool):
    """The head maps in f32, the network run on _compute_params."""
    params = _compute_params(dict(model.named_parameters()), half_precision)
    return [o.float() for o in functional_call(model, params, (imgs,))]


def make_train_step(strides, num_classes: int, radius: float,
                    half_precision: bool = False, *, device="cuda"):
    """Returns train_step(state, imgs, labels, generator) -> losses
    (trainer.py:234-288, without remat and patchify).

    imgs: (N, H, W, 2K) volumes; labels: (N, G, 5) f32 rows [class, cx,
    cy, w, h], zero rows padding; both are moved to the device. generator:
    a torch.Generator on the device for the stem's dropout masks. The step
    runs the model in training mode (batch statistics, running statistics
    updated, dropout), backpropagates total_loss to the f32 masters and
    updates them in place; it leaves the gradients in .grad and returns
    the dict of detached loss tensors."""
    dev = resolve_device(device)

    def train_step(state: TrainState, imgs, labels, generator):
        model = state.model.train()
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
        imgs = imgs.to(dev, torch.bfloat16 if half_precision else None)
        state.optimizer.zero_grad(set_to_none=True)
        outs = _forward(model, imgs, half_precision)
        losses = detector_loss(outs, labels.to(dev), strides, num_classes,
                               radius)
        losses["total_loss"].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_eval_step(strides, max_detections: int = 200,
                   half_precision: bool = False, *, device="cuda"):
    """Returns eval_step(state, imgs) -> (dets, keep) (trainer.py:291-315):
    the model in eval mode on _compute_params, f32 decode, then
    postprocess_batch with its defaults and `max_detections`."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, imgs):
        model = state.model.eval()
        imgs = imgs.to(dev, torch.bfloat16 if half_precision else None)
        decoded = eval_decode(_forward(model, imgs, half_precision), strides)
        return postprocess_batch(decoded, max_detections=max_detections)

    return eval_step
