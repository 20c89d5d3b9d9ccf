"""Plain reference of the TAF-K8 encode: the queue update, the leaky
transform, the nearest resize and the p64 layout of the 1 Mpx path.

The queue of b streams is kept as (b, H, W, K, 2) in the given dtype:
[age, polarity], age 0 the newest. A cell that received events in the bin
takes the mean of their t - 1 at age 0 and shifts its older slots by one
age (the oldest drops); every other slot ages by -1; a stream that received
no event keeps its queue. Viewed as (b, H, W, 2K) the channel is
c = 2 * age + p, the order of the detector's input volume.

Written from the description of the Temporal Active Focus encoder
(HarmoniaLeo/FRLW-EvD, generate_taf.py); imports nothing of the program.
"""

from __future__ import annotations

import torch

INIT_VALUE = -6000.0
LEAKY_DIV = 8.7


def new_queue(b: int, height: int, width: int, K: int, *, device,
              dtype=torch.float32) -> torch.Tensor:
    return torch.full((b, height, width, K, 2), INIT_VALUE, dtype=dtype,
                      device=device)


def queue_step(queue: torch.Tensor, xytp: torch.Tensor,
               n_valid: torch.Tensor) -> torch.Tensor:
    """One 10 ms bin: xytp (b, E, 4) [x, y, t, p] with integral x, y, p and
    t in [0, 1]; the first n_valid[i] slots of stream i are events. Returns
    the new queue, in the queue's dtype (the mean is taken in f32)."""
    b, H, W, K, _ = queue.shape
    E = xytp.shape[1]
    x = xytp[..., 0].long()
    y = xytp[..., 1].long()
    p = xytp[..., 3].long()
    t = xytp[..., 2]
    valid = ((torch.arange(E, device=xytp.device)[None] < n_valid[:, None])
             & (x >= 0) & (x < W) & (y >= 0) & (y < H) & (p >= 0) & (p < 2))
    stream = torch.arange(b, device=xytp.device)[:, None].expand(b, E)
    cell = ((stream * H + y) * W + x) * 2 + p
    cell, tv = cell[valid], t[valid] - 1.0
    cnt = torch.zeros(b * H * W * 2, device=xytp.device)
    tsum = torch.zeros_like(cnt)
    cnt.index_add_(0, cell, torch.ones_like(tv))
    tsum.index_add_(0, cell, tv)
    has = (cnt > 0).view(b, H, W, 1, 2)
    mean = (tsum / cnt.clamp_min(1.0)).view(b, H, W, 1, 2)
    aged = queue.float() - 1.0
    shifted = torch.cat([mean, aged[..., :-1, :]], dim=3)
    new = torch.where(has, shifted, aged)
    new = torch.where(valid.any(1).view(b, 1, 1, 1, 1), new, queue.float())
    return new.to(queue.dtype)


def volume(queue: torch.Tensor) -> torch.Tensor:
    """(b, H, W, K, 2) queue → (b, H, W, 2K) f32 volume in [0, 1]:
    max(0, 1 - log1p(-q) / 8.7), channel 2 * age + p."""
    b, H, W, K, _ = queue.shape
    v = torch.clamp_min(1.0 - torch.log1p(-queue.float()) / LEAKY_DIV, 0.0)
    return v.reshape(b, H, W, 2 * K)


def resize_indices(in_hw, out_hw, device):
    """Nearest resize: source row / column arange(out) * (in / out),
    products in f32, truncated (the serving path's rule)."""
    return tuple((torch.arange(o, dtype=torch.float32)
                  * torch.tensor(i / o, dtype=torch.float32)).long().to(device)
                 for i, o in zip(in_hw, out_hw))


def resize(vol: torch.Tensor, in_hw, out_hw) -> torch.Tensor:
    """(b, h, w, C) → (b, *out_hw, C)."""
    if tuple(in_hw) == tuple(out_hw):
        return vol
    ys, xs = resize_indices(in_hw, out_hw, vol.device)
    return vol[:, ys][:, :, xs]


def to_p64(full: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) → the folded p64 layout (b, H/2, (W/2) * 4C): per
    quarter-resolution pixel the four subpixel blocks s = 2 * (x & 1) +
    (y & 1), i.e. [top-left, bottom-left, top-right, bottom-right], each
    of C channels."""
    b, H, W, C = full.shape
    v = full.reshape(b, H // 2, 2, W // 2, 2, C)       # (b, y2, sy, x2, sx, c)
    return v.permute(0, 1, 3, 4, 2, 5).reshape(b, H // 2, (W // 2) * 4 * C)


def from_p64(folded: torch.Tensor, C: int) -> torch.Tensor:
    """Inverse of `to_p64`: (b, H/2, (W/2) * 4C) → (b, H, W, C)."""
    b, H2, WF = folded.shape
    W2 = WF // (4 * C)
    v = folded.reshape(b, H2, W2, 2, 2, C)             # (b, y2, x2, sx, sy, c)
    return v.permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * H2, 2 * W2, C)


def to_layout(full: torch.Tensor, layout: str) -> torch.Tensor:
    """(b, H, W, C) → the served path's layout of a queue or a volume:
    "p64_folded" or, for "nhwc", as it is."""
    return to_p64(full) if layout == "p64_folded" else full


def from_layout(x: torch.Tensor, layout: str, C: int) -> torch.Tensor:
    """The served path's queue or volume → (b, H, W, C)."""
    if layout == "p64_folded":
        return from_p64(x, C)
    return x.reshape(x.shape[0], x.shape[1], -1, C)
