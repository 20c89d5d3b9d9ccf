"""Anchor-free decoupled YOLOX head (counterpart of
frlw_evd_tpu/models/heads.py), with the reference's square w/h decode and
the SimOTA training loss.

The head returns raw per-level maps in the JAX layout: NHWC
(N, h, w, 4+1+C) ordered [reg, obj, cls]. The merged-tower variant
(`head_merged`) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .assign import simota_assign
from .blocks import BaseConv
from .losses import bce_with_logits, iou_loss


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


def compute_losses(level_outs, labels, hw_per_level, strides, num_classes,
                   radius):
    """Training loss over a batch (heads.py:196-258).

    Args:
      level_outs: list of raw (N, h, w, 5 + C) maps.
      labels: (N, G, 5) rows [class, cx, cy, w, h]; all-zero rows are
        padding.
    Returns a dict of scalar loss tensors (no host sync). SimOTA sees the
    predictions detached, so no gradient flows through the assignment.
    """
    x_shift, y_shift, stride = level_grids(hw_per_level, strides,
                                           device=labels.device)
    outputs = flatten_level_outputs(level_outs)              # (N, A, 5 + C)
    decoded = decode_outputs(outputs, x_shift, y_shift, stride)
    bbox_preds = decoded[..., :4]
    obj_logits = decoded[..., 4]
    cls_logits = decoded[..., 5:]

    gt_valid = labels.sum(-1) > 0                            # (N, G)
    gt_classes = labels[..., 0].to(torch.int64)
    gt_boxes = labels[..., 1:5]
    anchor_xc = (x_shift + 0.5) * stride
    anchor_yc = (y_shift + 0.5) * stride

    assignment = simota_assign(
        gt_boxes, gt_classes, gt_valid, bbox_preds.detach(),
        obj_logits.detach(), cls_logits.detach(), anchor_xc, anchor_yc,
        stride, radius, num_classes=num_classes)

    fg = assignment.fg_mask                                  # (N, A)
    num_fg = torch.clamp_min(assignment.num_fg.sum(), 1.0)
    num_gts = torch.clamp_min(assignment.num_gt.sum(), 1.0)

    n, a = fg.shape
    reg_target = torch.gather(
        gt_boxes, 1, assignment.matched_gt[..., None].expand(n, a, 4))
    cls_target = (F.one_hot(assignment.matched_cls, num_classes)
                  * assignment.pred_iou[..., None])
    fgf = fg.to(torch.float32)

    li = iou_loss(bbox_preds.reshape(-1, 4), reg_target.reshape(-1, 4))
    loss_iou = (li * fgf.reshape(-1)).sum() / num_fg
    loss_obj = bce_with_logits(obj_logits, fgf).sum() / num_fg
    lc = bce_with_logits(cls_logits, cls_target).sum(-1)
    loss_cls = (lc * fgf).sum() / num_fg

    reg_weight = 5.0
    return {
        "total_loss": reg_weight * loss_iou + loss_obj + loss_cls,
        "iou_loss": reg_weight * loss_iou,
        "obj_loss": loss_obj,
        "cls_loss": loss_cls,
        "num_fg_per_gt": num_fg / num_gts,
    }
