"""Numpy sequential reference ("oracle") for the four event encoders: the
port's own copy of frlw_evd_tpu/encode/oracle.py (numpy only).

Reproduces the reference math exactly — including channel order, dtype
truncation and streaming-memory quirks — so the jitted TPU encoders and the
offline generators can be validated against it:

  * event_volume      <- generate_eventvolume.py:15-42
  * count_image       <- generate_eventcountimage.py:19-41
  * sae               <- generate_surfaceofactiveevents.py:44-80
  * taf_bin / window  <- generate_taf.py:19-76
  * nearest_resize    <- torch.nn.functional.interpolate(mode='nearest')

Events are (N, 4) float arrays with columns [x, y, t, p]; t semantics vary per
encoder (see docstrings). All outputs are float32 CHW with reference channel
order; `to_uint8` applies the truncating uint8 conversion used when writing
blobs to disk.
"""

from __future__ import annotations

import numpy as np


def to_uint8(volume: np.ndarray, clip: bool = True) -> np.ndarray:
    """Reference blob dtype conversion: optional clip at 255, then truncation."""
    if clip:
        volume = np.where(volume > 255, 255, volume)
    return volume.astype(np.uint8)


def nearest_resize(volume: np.ndarray, target_hw) -> np.ndarray:
    """torch 'nearest' interpolate over the trailing two dims of a CHW array:
    src index = floor(dst * in/out)."""
    h_in, w_in = volume.shape[-2:]
    h_out, w_out = target_hw
    ys = (np.arange(h_out) * (h_in / h_out)).astype(np.int64)
    xs = (np.arange(w_out) * (w_in / w_out)).astype(np.int64)
    return volume[..., ys[:, None], xs[None, :]]


# ---------------------------------------------------------------------------
# Event Volume
# ---------------------------------------------------------------------------

def event_volume(events: np.ndarray, shape, volume_bins: int = 5) -> np.ndarray:
    """Bilinear temporal splat. t must be pre-normalised to [0, 1] over the
    time window. Returns (2*bins, H, W) float32 scaled to /bins*255 (unclipped;
    apply to_uint8 for the disk blob). Channel c = 2*bin + (1 - p)."""
    H, W = shape
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    t = events[:, 2].astype(np.float32)
    p = events[:, 3].astype(np.int64)

    t_star = volume_bins * t  # in [0, bins]
    img = np.zeros((H * W, volume_bins * 2), dtype=np.float32)
    flat = x + W * y
    for k in range(1, volume_bins + 1):
        w = 1.0 - np.abs(k - t_star)
        w = np.where(w >= 0, w, 0.0).astype(np.float32)
        np.add.at(img, (flat, 2 * (k - 1) + 0), w * p)
        np.add.at(img, (flat, 2 * (k - 1) + 1), w * (1 - p))
    vol = img.reshape(H, W, volume_bins * 2).transpose(2, 0, 1)
    return vol / volume_bins * 255.0


# ---------------------------------------------------------------------------
# Event Count Image
# ---------------------------------------------------------------------------

def count_image(events: np.ndarray, shape) -> np.ndarray:
    """Occupancy image: each event adds 0.05 to its (y, x, p) cell, clamp to 1,
    *255. Returns (2, H, W) float32 with channel = polarity (p=0 first)."""
    H, W = shape
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    p = events[:, 3].astype(np.int64)
    img = np.zeros(H * W * 2, dtype=np.float32)
    np.add.at(img, 2 * x + 2 * W * y + p, np.float32(0.05))
    img = np.minimum(img, 1.0)
    return img.reshape(H, W, 2).transpose(2, 0, 1) * 255.0


# ---------------------------------------------------------------------------
# Surface of Active Events
# ---------------------------------------------------------------------------

def sae(events: np.ndarray, shape, lamdas, memory, now: float):
    """Per-pixel-per-polarity last-event-timestamp surface with exponential
    decay. t is the raw microsecond timestamp. Events outside the sensor are
    dropped (reference :72). Returns ((len(lamdas)*2, H, W) float32 scaled
    *255, new_memory (2, H, W) of raw timestamps)."""
    H, W = shape
    keep = (events[:, 0] < W) & (events[:, 1] < H)
    events = events[keep]
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    t = events[:, 2].astype(np.float32)
    p = events[:, 3].astype(np.int64)

    t_img = np.full((2, H, W), np.float32(now - 5_000_000), dtype=np.float32)
    # duplicate indices: numpy fancy assignment keeps the last (= newest) value
    t_img[p, y, x] = t
    if memory is not None:
        t_img = np.where(t_img > memory, t_img, memory)
    memory = t_img
    dt = t_img - np.float32(now)
    surfaces = [np.exp(np.float32(lam) * dt) for lam in lamdas]
    ecd = np.stack(surfaces, 0).reshape(len(lamdas) * 2, H, W)
    return ecd * 255.0, memory


# ---------------------------------------------------------------------------
# Temporal Active Focus
# ---------------------------------------------------------------------------

def taf_init_state(shape, volume_bins: int) -> np.ndarray:
    """Fresh TAF queue: (H, W, 2, K) filled with -6000 (≈60 s age, which the
    leaky transform maps to ~0). Reference: generate_taf.py:207."""
    H, W = shape
    return np.full((H, W, 2, volume_bins), -6000.0, dtype=np.float32)


def taf_bin(events: np.ndarray, shape, state: np.ndarray) -> np.ndarray:
    """One 10 ms micro-bin TAF queue update (generate_taf.py:19-58).

    t must be pre-normalised to [0, 1] within the bin. For every pixel that
    received events, the oldest queue slot is dropped, survivors age by -1 and
    mean(t)-1 is appended; pixels without events age in place by -1. If NO
    pixel received events the whole state is untouched."""
    H, W = shape
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    t = events[:, 2].astype(np.float32)
    p = events[:, 3].astype(np.int64)

    cnt = np.zeros(H * W * 2, dtype=np.float32)
    np.add.at(cnt, p + 2 * x + 2 * W * y, np.float32(1.0))
    tsum = np.zeros(H * W * 2, dtype=np.float32)
    np.add.at(tsum, p + 2 * x + 2 * W * y, t - 1.0)
    tmean = tsum / (cnt + 1e-8)

    cnt = cnt.reshape(H, W, 2)
    tmean = tmean.reshape(H, W, 2)
    has = cnt > 0
    if not has.any():
        return state
    shifted = np.concatenate([state[..., 1:] - 1.0, tmean[..., None]], axis=-1)
    return np.where(has[..., None], shifted, state - 1.0).astype(np.float32)


def taf_window(events: np.ndarray, shape, start_time: int, end_time: int,
               bin_us: int, state: np.ndarray):
    """Run TAF over [start_time, end_time) in ceil((end-start)/bin_us) micro
    bins, replicating the reference z-bucketing (boundary events go to the
    later bin; generate_taf.py:201-203) and per-bin t normalisation (:215).

    Returns (volume (2K, H, W) raw ecd with channel = slot*2 + pol where slot 0
    is OLDEST, new_state)."""
    import math

    bins = math.ceil((end_time - start_time) / bin_us)
    t = events[:, 2]
    z = np.zeros(len(events), dtype=np.int64)
    for i in range(bins):
        sel = (t >= start_time + i * bin_us) & (t <= start_time + (i + 1) * bin_us)
        z[sel] = i
    for i in range(bins):
        ev = events[z == i].copy()
        t_min = start_time + i * bin_us
        t_max = start_time + (i + 1) * bin_us
        ev[:, 2] = (ev[:, 2] - t_min) / (t_max - t_min + 1e-8)
        state = taf_bin(ev, shape, state)
    K = state.shape[-1]
    H, W = shape
    volume = state.transpose(3, 2, 0, 1).reshape(K * 2, H, W)
    return volume, state


def leaky_transform(ecd: np.ndarray) -> np.ndarray:
    """f(x) = max(0, 1 - log1p(-x)/8.7) * 255 (generate_taf.py:69-76)."""
    out = np.log1p(-ecd)
    out = 1.0 - out / 8.7
    out = np.where(out < 0, 0.0, out)
    return out * 255.0


def taf_blob(volume: np.ndarray, volume_bins: int, target_hw=None):
    """Disk finisher: (2K,H,W) raw ecd → leaky → (K,2,H,W) → flip bins so the
    NEWEST bin comes first → (uint8 bins[:K/2] blob, bins[K/2:] blob)
    (generate_taf.py:226-235)."""
    if target_hw is not None:
        volume = nearest_resize(volume, target_hw)
    H, W = volume.shape[-2:]
    vol = volume.reshape(volume_bins, 2, H, W)
    vol = leaky_transform(vol)
    vol = vol[::-1]  # newest first
    half = volume_bins // 2
    blob_new = vol[:half].reshape(half * 2, H, W).astype(np.uint8)
    blob_old = vol[half:].reshape((volume_bins - half) * 2, H, W).astype(np.uint8)
    return blob_new, blob_old
