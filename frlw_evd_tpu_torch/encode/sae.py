"""Surface of Active Events encoder (counterpart of
frlw_evd_tpu/encode/sae.py; reference generate_surfaceofactiveevents.py).

Per-pixel-per-polarity last-event timestamp (a scatter-max: event streams
are time-ordered, so max == last write), max-merged with a running memory,
then decayed at several lambda at once. State: (H, W, 2) f32 raw
timestamps. As in JAX, n_valid, x < W and y < H mask the slots; an index
below 0 (which JAX wraps) drops.
"""

from __future__ import annotations

import math

import torch

from .common import _in_range

LAMDAS = (0.00001, 0.0000025, 0.000001)


def sae_init_state(height: int, width: int, now: float = 0.0, *,
                   device="cuda") -> torch.Tensor:
    """Default memory: every pixel last fired 5 s before `now`."""
    return torch.full((height, width, 2), now - 5_000_000.0,
                      dtype=torch.float32, device=device)


def encode_sae_batch(xytp, n_valid, memory, now, *, height: int, width: int,
                     lamdas=LAMDAS):
    """Batched encode_sae: xytp (B, E, 4), n_valid (B,), memory (B, H, W, 2),
    now (B,) → ((B, H, W, 2*len(lamdas)) f32 x255, new memory)."""
    B, E, _ = xytp.shape
    dev = xytp.device
    P = height * width * 2
    x = xytp[..., 0].to(torch.int32)
    y = xytp[..., 1].to(torch.int32)
    t = xytp[..., 2]
    p = xytp[..., 3].to(torch.int32)
    now = torch.as_tensor(now, dtype=torch.float32, device=dev).expand(B)
    idx = (y * width + x) * 2 + p
    ok = ((torch.arange(E, device=dev)[None, :] < n_valid.to(dev)[:, None])
          & (x < width) & (y < height) & _in_range(idx, P))
    base = (now - 5_000_000.0)[:, None].expand(B, P + 1).clone()
    base[:, P] = -math.inf
    t_img = base.scatter_reduce(1, torch.where(ok, idx, P).long(), t, "amax",
                                include_self=True)[:, :P]
    t_img = torch.maximum(t_img.reshape(B, height, width, 2), memory)
    dt = t_img - now.view(B, 1, 1, 1)
    ecd = torch.cat([torch.exp(lam * dt) for lam in
                     torch.tensor(lamdas, dtype=torch.float32)], -1)
    return ecd * 255.0, t_img


def encode_sae(xytp, n_valid, memory, now, *, height: int, width: int,
               lamdas=LAMDAS):
    """((H, W, 2*len(lamdas)) f32 x255, new memory (H, W, 2)) of one padded
    window (sae.py:25-49); channel c = 2*lam_idx + p, t raw microseconds."""
    n = torch.as_tensor(n_valid, device=xytp.device).reshape(1)
    out, mem = encode_sae_batch(xytp[None], n, memory[None], now,
                                height=height, width=width, lamdas=lamdas)
    return out[0], mem[0]
