"""Temporal Active Focus encoder (counterpart of frlw_evd_tpu/encode/taf.py).

The queue semantics are those of the reference TAF encoder: a cell that
received events this bin drops its oldest slot, ages the others by -1 and
appends mean(t) - 1; a cell without events ages every slot by -1; a bin in
which no cell of the stream received anything leaves the state untouched.

The offline encoder keeps one stream's queue as (H, W, 2, K) f32, slot K - 1
the newest; `encode_taf_window` runs it over pre-bucketed 10 ms micro-bins
(a loop where JAX scans) and `taf_state_to_volume` makes the network input,
newest bin first, leaky-transformed to [0, 255].
"""

from __future__ import annotations

import math

import numpy as np
import torch

INIT_VALUE = -6000.0   # ≈ 60 s of age: leaky_transform maps it to ~0


def _leaky_unit(ecd: torch.Tensor) -> torch.Tensor:
    """f(x) = max(0, 1 - log1p(-x)/8.7): the [0, 1] detector volume of the
    fused update kernels (leaky_transform times 1/255). The division is a
    multiply by the f32 reciprocal, as in those kernels."""
    return torch.clamp_min(1.0 - torch.log1p(-ecd) * (1.0 / 8.7), 0.0)


def leaky_transform(ecd: torch.Tensor) -> torch.Tensor:
    """f(x) = max(0, 1 - log1p(-x)/8.7) * 255 (encode/taf.py:77-80)."""
    return torch.clamp_min(1.0 - torch.log1p(-ecd) / 8.7, 0.0) * 255.0


def taf_init_state(height: int, width: int, volume_bins: int, *,
                   device="cuda") -> torch.Tensor:
    """Fresh (H, W, 2, K) queue filled with -6000."""
    return torch.full((height, width, 2, volume_bins), INIT_VALUE,
                      dtype=torch.float32, device=device)


def taf_bin_step(state: torch.Tensor, xytp: torch.Tensor,
                 n_valid) -> torch.Tensor:
    """One micro-bin queue update (encode/taf.py:34-63).

    Args:
      state: (H, W, 2, K) f32 queue.
      xytp: (E, 4) padded events; t normalised to [0, 1] within the bin.
      n_valid: number of real events; the other slots are dropped.
    Returns the new (H, W, 2, K) state. As in JAX only n_valid masks the
    slots: a cell index past the grid drops, and one below 0 (where JAX
    wraps it) drops too.
    """
    H, W = state.shape[0], state.shape[1]
    P = H * W * 2
    x = xytp[:, 0].to(torch.int32)
    y = xytp[:, 1].to(torch.int32)
    t = xytp[:, 2]
    p = xytp[:, 3].to(torch.int32)
    idx = (y * W + x) * 2 + p
    ok = ((torch.arange(xytp.shape[0], device=xytp.device) < n_valid)
          & (idx >= 0) & (idx < P))
    bins = torch.where(ok, idx, P).long()
    acc = torch.zeros(P + 1, 2, dtype=torch.float32, device=state.device)
    acc.index_add_(0, bins, torch.stack([torch.ones_like(t), t - 1.0], -1))
    cnt, tsum = acc[:P, 0], acc[:P, 1]
    tmean = (tsum / (cnt + 1e-8)).view(H, W, 2)
    has = (cnt > 0).view(H, W, 2)
    shifted = torch.cat([state[..., 1:] - 1.0, tmean[..., None]], -1)
    updated = torch.where(has[..., None], shifted, state - 1.0)
    return torch.where(has.any(), updated, state)


def encode_taf_window(state: torch.Tensor, binned_xytp: torch.Tensor,
                      bin_valid: torch.Tensor) -> torch.Tensor:
    """The queue over pre-bucketed micro-bins, in order (encode/taf.py:66-84,
    a loop where JAX scans).

    Args:
      state: (H, W, 2, K) queue carried across windows.
      binned_xytp: (n_bins, E, 4) events per bin, t normalised per bin.
      bin_valid: (n_bins,) valid-event counts.
    Returns the final (H, W, 2, K) state.
    """
    for ev, n in zip(binned_xytp, bin_valid):
        state = taf_bin_step(state, ev, n)
    return state


def taf_state_to_volume(state: torch.Tensor) -> torch.Tensor:
    """(H, W, 2, K) queue → (H, W, 2K) network input, newest bin first,
    channel c = 2 * bin_age + p, leaky-transformed to [0, 255]
    (encode/taf.py:83-93)."""
    H, W, _, K = state.shape
    vol = state.flip(-1).transpose(2, 3).reshape(H, W, 2 * K)
    return leaky_transform(vol)


def bucket_events_for_taf(xytp, start_time: int, end_time: int, bin_us: int,
                          max_events_per_bin: int):
    """Host-side: split raw [x, y, t, p] (t in µs, numpy) into per-bin padded
    arrays with per-bin t normalisation, as the reference buckets them
    (boundary events to the later bin; encode/taf.py:96-123).

    Returns (binned (n_bins, E, 4) float32, bin_valid (n_bins,) int32),
    numpy.
    """
    bins = math.ceil((end_time - start_time) / bin_us)
    t = xytp[:, 2]
    z = np.zeros(len(xytp), dtype=np.int64)
    for i in range(bins):
        sel = ((t >= start_time + i * bin_us)
               & (t <= start_time + (i + 1) * bin_us))
        z[sel] = i
    out = np.zeros((bins, max_events_per_bin, 4), dtype=np.float32)
    n_valid = np.zeros(bins, dtype=np.int32)
    for i in range(bins):
        ev = xytp[z == i]
        t_min = start_time + i * bin_us
        t_max = start_time + (i + 1) * bin_us
        n = min(len(ev), max_events_per_bin)
        out[i, :n] = ev[len(ev) - n:]
        out[i, :n, 2] = (out[i, :n, 2] - t_min) / (t_max - t_min + 1e-8)
        n_valid[i] = n
    return out, n_valid
