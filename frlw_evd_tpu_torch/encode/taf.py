"""Temporal Active Focus helpers (counterpart of frlw_evd_tpu/encode/taf.py).

The queue semantics are those of the reference TAF encoder: a cell that
received events this bin drops its oldest slot, ages the others by -1 and
appends mean(t) - 1; a cell without events ages every slot by -1; a bin in
which no cell of the stream received anything leaves the state untouched.
"""

from __future__ import annotations

import torch

INIT_VALUE = -6000.0   # ≈ 60 s of age: leaky_transform maps it to ~0


def leaky_transform(ecd: torch.Tensor) -> torch.Tensor:
    """f(x) = max(0, 1 - log1p(-x)/8.7): the [0, 1] detector volume of the
    fused update kernels (encode/taf.py:77-80 times 1/255). The division is
    a multiply by the f32 reciprocal, as in those kernels."""
    return torch.clamp_min(1.0 - torch.log1p(-ecd) * (1.0 / 8.7), 0.0)
