"""The interface between a driver and what it drives: the program's
serving path (program.py) or the control put in its place
(reference/control.py)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class System(NamedTuple):
    """run_step(state, xytp, n_valid) -> (state, (dets, keep)) with its two
    stages {"encode_transform": (state, xytp, n_valid) -> (state, vol),
    "detect": vol -> (dets, keep)}, the detector module (its input is the
    volume, its output the per-level head maps) and a fresh state."""
    run_step: Callable
    stages: dict
    model: torch.nn.Module
    new_state: Callable[[], torch.Tensor]
