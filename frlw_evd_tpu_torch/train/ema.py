"""Model EMA (counterpart of frlw_evd_tpu/train/ema.py): decay 0.9999 with
the reference's warm-up ramp exp(-updates / 2000), over the parameters
only (not the BatchNorm statistics)."""

from __future__ import annotations

import math

import torch


def ema_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Detached copies of the parameters, by name."""
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor], updates: int,
               decay: float = 0.9999) -> dict[str, torch.Tensor]:
    """One EMA step in place, d = decay * (1 - exp(-updates / 2000)), with
    `updates` the step count after the optimiser's update
    (trainer.py:521-523): ema = ema * d + p * (1 - d). Returns ema_params."""
    d = decay * (1.0 - math.exp(-updates / 2000.0))
    for k, e in ema_params.items():
        e.copy_(e * d + params[k].detach() * (1.0 - d))
    return ema_params
