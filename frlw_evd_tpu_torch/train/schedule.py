"""Learning-rate schedules (counterpart of frlw_evd_tpu/train/schedule.py).

Each returns schedule(step) -> float for a host step count. The train
step evaluates it at the count of updates made so far (before this one)
and sets it as the optimiser's lr, as optax's scale_by_schedule does; the
formulas count iterations from 1 (`iters = step + 1`), as the reference's
scheduler does (core/exp.py:150).
"""

from __future__ import annotations

import math


def yolox_warm_cos_schedule(lr: float, min_lr_ratio: float, total_iters: int,
                            warmup_total_iters: int,
                            warmup_lr_start: float = 0.0,
                            no_aug_iter: int = 0):
    """Quadratic warm-up from warmup_lr_start, then cosine from lr to
    lr * min_lr_ratio (schedule.py:13-30)."""
    min_lr = lr * min_lr_ratio

    def schedule(step: int) -> float:
        iters = step + 1
        if no_aug_iter > 0 and iters >= total_iters - no_aug_iter:
            return min_lr
        if iters <= warmup_total_iters:
            return (lr - warmup_lr_start) * (
                iters / max(float(warmup_total_iters), 1.0)) ** 2 \
                + warmup_lr_start
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
            math.pi * (iters - warmup_total_iters)
            / max(total_iters - warmup_total_iters - no_aug_iter, 1)))

    return schedule


def cos_schedule(lr: float, total_iters: int):
    """Plain cosine (schedule.py:33-40)."""

    def schedule(step: int) -> float:
        return lr * 0.5 * (1.0 + math.cos(math.pi * (step + 1) / total_iters))

    return schedule


def warm_cos_schedule(lr: float, total_iters: int, warmup_total_iters: int,
                      warmup_lr_start: float = 1e-6):
    """Linear warm-up, then cosine (schedule.py:43-56)."""

    def schedule(step: int) -> float:
        iters = step + 1
        if iters <= warmup_total_iters:
            return (lr - warmup_lr_start) * iters / max(
                float(warmup_total_iters), 1.0) + warmup_lr_start
        return lr * 0.5 * (1.0 + math.cos(
            math.pi * (iters - warmup_total_iters)
            / max(total_iters - warmup_total_iters, 1)))

    return schedule


def multistep_schedule(lr: float, milestones, gamma: float = 0.1):
    """Step decay at milestone iterations (schedule.py:59-70)."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        return lr * gamma ** sum(step + 1 >= m for m in ms)

    return schedule
