"""Event Count Image encoder (counterpart of
frlw_evd_tpu/encode/count_image.py; reference generate_eventcountimage.py).

Each event adds 0.05 to its (y, x, p) cell; clamp at 1; x255. HWC output
with channel = polarity (p = 0 first). As in JAX only n_valid masks the
slots: an index past the grid drops, and one below 0 (which JAX wraps)
drops too. `index_add_` on CUDA adds in no fixed order, so a cell's sum of
0.05s matches JAX's to f32 reordering.
"""

from __future__ import annotations

import torch

from .common import _in_range
from .scatter import _stream_bins


def encode_count_image_batch(xytp: torch.Tensor, n_valid: torch.Tensor, *,
                             height: int, width: int) -> torch.Tensor:
    """(B, E, 4) padded events, n_valid (B,) → (B, H, W, 2) f32 in
    [0, 255] (count_image.py:32-35, the vmap of encode_count_image)."""
    B, E, _ = xytp.shape
    P = height * width * 2
    x = xytp[..., 0].to(torch.int32)
    y = xytp[..., 1].to(torch.int32)
    p = xytp[..., 3].to(torch.int32)
    idx = (y * width + x) * 2 + p
    slot = torch.arange(E, device=xytp.device)
    ok = (slot[None, :] < n_valid.to(xytp.device)[:, None]) \
        & _in_range(idx, P)
    img = torch.zeros(B * (P + 1), dtype=torch.float32, device=xytp.device)
    img.index_add_(0, _stream_bins(idx, ok, P),
                   torch.full((B * E,), 0.05, dtype=torch.float32,
                              device=xytp.device))
    img = torch.clamp_max(img.view(B, P + 1)[:, :P], 1.0)
    return img.reshape(B, height, width, 2) * 255.0


def encode_count_image(xytp: torch.Tensor, n_valid, *, height: int,
                       width: int) -> torch.Tensor:
    """(E, 4) padded events → (H, W, 2) f32 in [0, 255]
    (count_image.py:15-29)."""
    n = torch.as_tensor(n_valid, device=xytp.device).reshape(1)
    return encode_count_image_batch(xytp[None], n, height=height,
                                    width=width)[0]
