"""Anchor-free decoupled YOLOX head (counterpart of
frlw_evd_tpu/models/heads.py), with the reference's square w/h decode and
the SimOTA training loss.

The head returns raw per-level maps in the JAX layout: NHWC
(N, h, w, 4+1+C) ordered [reg, obj, cls]. With `merged` (build_detector's
`head_merged`) each level's cls and reg towers run as two double-width
convs on the canonical parameters (`_merged_towers`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .assign import simota_assign
from .blocks import (BaseConv, batch_norm_train, get_activation,
                     update_running_)
from .losses import bce_with_logits, iou_loss


class YOLOXHead(nn.Module):
    """Separate cls and reg towers per level (heads.py:125-164), or with
    `merged` the two towers of a level as two double-width convs
    (heads.py:69-122) on the same submodules and state_dict, so one
    checkpoint serves both. `merged_hook`, when set, is asked for each
    merged conv first (models/quantize.py's calibration and int8 sites):
    merged_hook(k, layer, h) → the conv's output, or None for the plain
    conv."""

    merged_hook = None

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 strides: Sequence[int] = (8, 16, 32), width: int = 256,
                 act: str = "silu", prior_prob: float = 1e-2,
                 merged: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.width = width
        self.merged = merged
        self.act = get_activation(act)
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
            if self.merged:
                cls_feat, reg_feat = self._merged_towers(k, x)
            else:
                cls_feat = getattr(self, f"cls_convs_{k}_1")(
                    getattr(self, f"cls_convs_{k}_0")(x))
                reg_feat = getattr(self, f"reg_convs_{k}_1")(
                    getattr(self, f"reg_convs_{k}_0")(x))
            out = torch.cat([getattr(self, f"reg_preds_{k}")(reg_feat),
                             getattr(self, f"obj_preds_{k}")(reg_feat),
                             getattr(self, f"cls_preds_{k}")(cls_feat)], dim=1)
            outs.append(out.permute(0, 2, 3, 1))
        return outs

    def _merged_towers(self, k: int, x):
        """Level k's towers as two convs (heads.py:69-122): layer 0 one
        dense 3x3 conv W → 2W on the output-concatenated cls and reg
        kernels, layer 1 one grouped (groups 2) 3x3 conv 2W → 2W. Each
        BatchNorm runs in f32 on the conv's output cast to f32 (an f64
        network's stays f64, where JAX's casts it to f32), on the
        concatenated per-branch statistics at eval; in training on the
        batch statistics, each branch's running statistics updated from
        its own slice. Returns (cls_feat, reg_feat)."""
        W, h = self.width, x
        for layer in (0, 1):
            towers = [getattr(self, f"{b}_convs_{k}_{layer}")
                      for b in ("cls", "reg")]
            y = (None if self.merged_hook is None
                 else self.merged_hook(k, layer, h))
            if y is None:
                kernel = torch.cat([t.conv.weight for t in towers])
                y = F.conv2d(h, kernel.to(h.dtype), padding=1,
                             groups=2 if layer else 1)
            y = y.to(torch.promote_types(y.dtype, torch.float32))
            bns = [t.bn for t in towers]
            scale = torch.cat([bn.weight for bn in bns])
            bias = torch.cat([bn.bias for bn in bns])
            if self.training:
                y, mean, var = batch_norm_train(y, scale, bias, bns[0].eps)
                for i, bn in enumerate(bns):
                    if bn.update_stats:
                        update_running_(bn, mean[i * W:(i + 1) * W],
                                        var[i * W:(i + 1) * W])
            else:
                y = F.batch_norm(
                    y, torch.cat([bn.running_mean for bn in bns]).to(y.dtype),
                    torch.cat([bn.running_var for bn in bns]).to(y.dtype),
                    scale.to(y.dtype), bias.to(y.dtype), False, 0.0,
                    bns[0].eps)
            h = self.act(y.to(x.dtype))
        return h[:, :W], h[:, W:]


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
