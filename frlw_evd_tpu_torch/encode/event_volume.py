"""Event Volume encoder: bilinear temporal splat onto 2*bins channels
(counterpart of frlw_evd_tpu/encode/event_volume.py; reference
generate_eventvolume.py).

Each event adds to at most two adjacent temporal bins (the weight
max(0, 1 - |k - bins*t|) is nonzero for two integers k at most), bins
1..bins; channel c = 2*(bin - 1) + (1 - p); the volume is scaled by
/bins*255, not clipped. As in JAX only n_valid and the bin range mask the
slots; an index below 0 (which JAX wraps) drops. `index_add_` on CUDA adds
in no fixed order: sums match JAX's to f32 reordering.
"""

from __future__ import annotations

import torch

from .common import _in_range
from .scatter import _stream_bins


def encode_event_volume_batch(xytp: torch.Tensor, n_valid: torch.Tensor, *,
                              height: int, width: int,
                              volume_bins: int = 5) -> torch.Tensor:
    """(B, E, 4) f32 [x, y, t, p], t normalised to [0, 1], n_valid (B,) →
    (B, H, W, 2*bins) f32 (event_volume.py:22-68)."""
    B, E, _ = xytp.shape
    dev = xytp.device
    x = xytp[..., 0].to(torch.int32)
    y = xytp[..., 1].to(torch.int32)
    p = xytp[..., 3].to(torch.int32)
    t_star = volume_bins * xytp[..., 2]
    k0 = torch.floor(t_star).to(torch.int32)
    w1 = t_star - k0
    w0 = 1.0 - w1
    pix = y * width + x
    valid = torch.arange(E, device=dev)[None, :] < n_valid.to(dev)[:, None]
    size = height * width * 2 * volume_bins

    def bins_of(k):
        c = pix * (2 * volume_bins) + 2 * (k - 1) + (1 - p)
        ok = valid & (k >= 1) & (k <= volume_bins) & _in_range(c, size)
        return _stream_bins(c, ok, size)

    img = torch.zeros(B * (size + 1), dtype=torch.float32, device=dev)
    img.index_add_(0, bins_of(k0), w0.reshape(-1))
    img.index_add_(0, bins_of(k0 + 1), w1.reshape(-1))
    vol = img.view(B, size + 1)[:, :size].reshape(B, height, width,
                                                  2 * volume_bins)
    return vol / volume_bins * 255.0


def encode_event_volume(xytp: torch.Tensor, n_valid, *, height: int,
                        width: int, volume_bins: int = 5) -> torch.Tensor:
    """One padded window (E, 4) → (H, W, 2*bins) f32
    (event_volume.py:22-59)."""
    n = torch.as_tensor(n_valid, device=xytp.device).reshape(1)
    return encode_event_volume_batch(xytp[None], n, height=height,
                                     width=width,
                                     volume_bins=volume_bins)[0]
