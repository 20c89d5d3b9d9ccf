"""Shared helpers of the encoders (counterpart of
frlw_evd_tpu/encode/common.py).

Variable-length event streams come as padded (E, 4) float32 buffers
[x, y, t, p] with a count of valid rows. Where JAX maps a padded row to an
out-of-range index and lets `mode="drop"` drop it, the port drops every
index outside [0, size): JAX would wrap a negative one (numpy style, before
its bounds check); the port never does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

OOB = 2 ** 30   # the index a padded row maps to (common.py:62)


def events_struct_to_xytp(events: np.ndarray) -> np.ndarray:
    """Decoded structured events → (N, 4) float32 [x, y, t, p], numpy
    (common.py:18-28)."""
    t_field = "ts" if "ts" in events.dtype.names else "t"
    out = np.empty((len(events), 4), dtype=np.float32)
    out[:, 0] = events["x"]
    out[:, 1] = events["y"]
    out[:, 2] = events[t_field]
    out[:, 3] = events["p"]
    return out


def pad_events(xytp: np.ndarray, max_events: int):
    """Pad or truncate to (max_events, 4), numpy; returns (padded, n_valid).
    When truncating, the OLDEST events are dropped (common.py:31-40)."""
    n = len(xytp)
    if n > max_events:
        xytp = xytp[n - max_events:]
        n = max_events
    out = np.zeros((max_events, 4), dtype=np.float32)
    out[:n] = xytp
    return out, n


def bucket_size(n: int, buckets=(2**12, 2**14, 2**16, 2**18, 2**20,
                                 2**22)) -> int:
    """Smallest bucket holding n events (common.py:43-49)."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** math.ceil(math.log2(max(n, 1))))


def valid_mask(n_valid, max_events: int, device=None) -> torch.Tensor:
    """(max_events,) bool, True for the first n_valid slots."""
    return torch.arange(max_events, device=device) < n_valid


def flat_index(x, y, p, c, W: int, n_valid=None,
               max_events: int | None = None, stride_c: int = 1):
    """Linearised scatter index (common.py:56-64); slots past n_valid map to
    OOB, which the scatters below drop."""
    idx = ((y * W + x) * stride_c + c) if stride_c > 1 else (y * W + x)
    if n_valid is not None:
        idx = torch.where(valid_mask(n_valid, max_events, idx.device), idx,
                          OOB)
    return idx


def nearest_resize_indices(in_hw, out_hw, device=None,
                           dtype=torch.float32):
    """Row and column source indices of a 'nearest' resize from in_hw to
    out_hw: arange(out) * (in / out) in `dtype`, truncated. The JAX helpers
    (common.py:70-71) and pipelines (bench.py:204-205) compute it in f32,
    make_pipeline in f64 (bench.py:310-311); 304/320 is not exact in
    binary, so the precision decides the indices."""
    return tuple(
        (torch.arange(o, dtype=dtype) * torch.tensor(i / o, dtype=dtype))
        .to(torch.int64).to(device) for i, o in zip(in_hw, out_hw))


def nearest_resize_chw(volume: torch.Tensor, target_hw) -> torch.Tensor:
    """'nearest' resize over the trailing (H, W) dims (common.py:67-73)."""
    ys, xs = nearest_resize_indices(volume.shape[-2:], target_hw,
                                    volume.device)
    return volume.index_select(-2, ys).index_select(-1, xs)


def nearest_resize_hwc(volume: torch.Tensor, target_hw) -> torch.Tensor:
    """'nearest' resize over the leading (H, W) dims of HWC
    (common.py:76-82)."""
    ys, xs = nearest_resize_indices(volume.shape[:2], target_hw,
                                    volume.device)
    return volume.index_select(0, ys).index_select(1, xs)


def _in_range(idx: torch.Tensor, size: int) -> torch.Tensor:
    return (idx >= 0) & (idx < size)


def scatter_add_flat(size: int, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Dense (size,) f32 scatter-add; indices outside [0, size) dropped
    (common.py:85-87)."""
    ok = _in_range(idx, size)
    out = torch.zeros(size + 1, dtype=torch.float32, device=idx.device)
    out.index_add_(0, torch.where(ok, idx, size).long(),
                   torch.where(ok, vals, 0.0).to(torch.float32))
    return out[:size]


def scatter_max_flat(init: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Dense scatter-max into a copy of `init`; indices outside
    [0, init.numel()) dropped (common.py:90-92)."""
    size = init.shape[0]
    ok = _in_range(idx, size)
    out = torch.cat([init, init.new_full((1,), -math.inf)])
    return out.scatter_reduce(0, torch.where(ok, idx, size).long(), vals,
                              "amax", include_self=True)[:size]
