"""Checkpoint save and load as native .pth (counterpart of
frlw_evd_tpu/train/checkpoints.py::save_checkpoint, load_checkpoint).

One file holds the model's state_dict (f32 masters and BatchNorm
statistics), the optimiser's, the EMA parameters when kept, the update
count, the epoch and the best score. It is written to a temporary file
beside the target and moved over it with os.replace, so a crash leaves the
previous checkpoint whole. The transfer parts (save_part_checkpoints,
load_pretrained_backbone) are .pth files of the backbone's and the neck's
parameters and BatchNorm statistics. Importing the upstream reference's
.pth (import_torch_checkpoint, default_rename) is not ported yet.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:
    from .trainer import TrainState


def _save(obj, path: str) -> None:
    """torch.save to a temporary file beside `path`, moved over it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    max_score: float,
                    ema: Optional[dict[str, torch.Tensor]] = None) -> None:
    _save({"model": state.model.state_dict(),
           "optimizer": state.optimizer.state_dict(),
           "ema": ema, "step": state.step, "epoch": epoch,
           "max_score": max_score}, path)


def load_checkpoint(path: str, state: TrainState,
                    ema: Optional[dict[str, torch.Tensor]] = None):
    """Load `path` into `state` (and into `ema` in place, when given) on
    the state's device. Returns (state, the epoch to resume at, max_score),
    as the JAX function does."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if ema is not None:
        if ckpt["ema"] is None:
            raise KeyError(f"{path} holds no EMA parameters")
        with torch.no_grad():
            for k, e in ema.items():
                e.copy_(ckpt["ema"][k])
    return state, ckpt["epoch"] + 1, ckpt.get("max_score", 0.0)


PARTS = ("backbone", "neck")


def _part_path(path: str) -> str:
    path = os.path.abspath(path)
    return path if path.endswith(".pth") else path + ".pth"


def save_part_checkpoints(path_prefix: str, state: TrainState) -> None:
    """Per-part checkpoints for transfer (checkpoints.py:304-327, reference
    saveCheckpoint:204-210): <path_prefix>_backbone.pth and
    <path_prefix>_neck.pth, each the part's state_dict (parameters and
    BatchNorm statistics, keys relative to the part)."""
    for part in PARTS:
        module = getattr(state.model, part, None)
        if module is not None:
            _save(module.state_dict(), f"{path_prefix}_{part}.pth")


def load_pretrained_backbone(path: str, state: TrainState) -> TrainState:
    """Load a backbone part (`path`, with or without .pth) into the state's
    model in place (checkpoints.py:330-351, reference loadPretrained,
    core/exp.py:178-193). Returns the state."""
    part = _part_path(path)
    if not os.path.exists(part):
        raise FileNotFoundError(f"no checkpoint found at '{path}'")
    device = next(state.model.parameters()).device
    state.model.backbone.load_state_dict(
        torch.load(part, map_location=device, weights_only=True))
    return state
