"""Anchor-free decoupled YOLOX head at eval (counterpart of
frlw_evd_tpu/models/heads.py), with the reference's square w/h decode.

The head returns raw per-level maps in the JAX layout: NHWC
(N, h, w, 4+1+C) ordered [reg, obj, cls]. The merged-tower variant
(`head_merged`) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .blocks import BaseConv


class YOLOXHead(nn.Module):
    """Separate cls and reg towers per level (heads.py:125-164)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 strides: Sequence[int] = (8, 16, 32), width: int = 256,
                 act: str = "silu", prior_prob: float = 1e-2):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        for k, cin in enumerate(in_channels):
            self.add_module(f"stems_{k}", BaseConv(cin, width, 1, act=act))
            for branch in ("cls", "reg"):
                for layer in (0, 1):
                    self.add_module(f"{branch}_convs_{k}_{layer}",
                                    BaseConv(width, width, 3, act=act))
            self.add_module(f"cls_preds_{k}", nn.Conv2d(width, num_classes, 1))
            self.add_module(f"reg_preds_{k}", nn.Conv2d(width, 4, 1))
            self.add_module(f"obj_preds_{k}", nn.Conv2d(width, 1, 1))

    def forward(self, features):
        outs = []
        for k, x in enumerate(features):
            x = getattr(self, f"stems_{k}")(x)
            cls_feat = getattr(self, f"cls_convs_{k}_1")(
                getattr(self, f"cls_convs_{k}_0")(x))
            reg_feat = getattr(self, f"reg_convs_{k}_1")(
                getattr(self, f"reg_convs_{k}_0")(x))
            out = torch.cat([getattr(self, f"reg_preds_{k}")(reg_feat),
                             getattr(self, f"obj_preds_{k}")(reg_feat),
                             getattr(self, f"cls_preds_{k}")(cls_feat)], dim=1)
            outs.append(out.permute(0, 2, 3, 1))
        return outs


def level_grids(hw_per_level, strides, device=None):
    """Anchor metadata per flattened anchor, concatenated over levels in
    (y, x) row-major order (heads.py:167-179): (x_shift, y_shift, stride),
    each an (A,) float32 tensor."""
    xs, ys, ss = [], [], []
    for (h, w), s in zip(hw_per_level, strides):
        yy, xx = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        xs.append(xx.reshape(-1))
        ys.append(yy.reshape(-1))
        ss.append(torch.full((h * w,), s, device=device))
    return tuple(torch.cat(a).to(torch.float32) for a in (xs, ys, ss))


def flatten_level_outputs(level_outs):
    """[(N, h, w, ch)] → (N, A, ch) with per-level (y, x) row-major anchors."""
    return torch.cat([o.reshape(o.shape[0], -1, o.shape[-1])
                      for o in level_outs], dim=1)


def decode_outputs(outputs, x_shift, y_shift, stride):
    """Decode raw (N, A, 4+1+C): xy = (pred + grid) * stride,
    wh = pred^2 * stride (heads.py:188-193). obj/cls pass through."""
    xy = (outputs[..., :2] + torch.stack([x_shift, y_shift], -1)) \
        * stride[:, None]
    wh = torch.square(outputs[..., 2:4]) * stride[:, None]
    return torch.cat([xy, wh, outputs[..., 4:]], dim=-1)
