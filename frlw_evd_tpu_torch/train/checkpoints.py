"""Checkpoint save and load as native .pth (counterpart of
frlw_evd_tpu/train/checkpoints.py::save_checkpoint, load_checkpoint).

One file holds the model's state_dict (f32 masters and BatchNorm
statistics), the optimiser's, the EMA parameters when kept, the update
count, the epoch and the best score. It is written to a temporary file
beside the target and moved over it with os.replace, so a crash leaves the
previous checkpoint whole. Importing the upstream reference's .pth
(import_torch_checkpoint, default_rename) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .trainer import TrainState


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    max_score: float,
                    ema: Optional[dict[str, torch.Tensor]] = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "ema": ema, "step": state.step, "epoch": epoch,
                "max_score": max_score}, tmp)
    os.replace(tmp, path)


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
