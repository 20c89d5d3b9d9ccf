"""YOLOv3 detector family (counterpart of frlw_evd_tpu/models/yolov3.py).

Darknet-53 (LeakyReLU convs with bias, an optional BFM stem on the TAF
volume), the conv-set FPN with the align-corners bilinear upsample, the
anchor head (9 COCO anchors, sigmoid-xy / exp-wh decode), the GIoU loss
with GIoU-as-objectness target, and the host-side numpy anchor
assignment `gt_creator`.

The network runs NCHW inside; the detector takes the NHWC volume and
returns NHWC head maps, each (N, h, w, KA * (1 + C + 4)) with the channels
[KA obj | KA*C cls | KA*4 reg], as JAX's. Every function below reads an
anchor's index as (y, x, a) in that order, so the maps are NHWC before any
reshape.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist
from .blocks import BaseConv
from .stems import BinsFusionModule

# 9 COCO anchors, [w, h] per (scale, anchor) (yolov3.py:25-27)
ANCHOR_SIZE2 = [[10, 13], [16, 30], [33, 23],
                [30, 61], [62, 45], [59, 119],
                [116, 90], [156, 198], [373, 326]]
STRIDES = (8, 16, 32)


class ConvBnLeaky(BaseConv):
    """Conv with bias → BN → LeakyReLU(0.1) (yolov3.py:34-50)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1):
        super().__init__(in_channels, out_channels, ksize, stride, bias=True,
                         act="lrelu")


class ResBlock(nn.Module):
    """nblocks × (1x1 halve → 3x3 restore → residual add) (yolov3.py:53)."""

    def __init__(self, channels: int, nblocks: int = 1):
        super().__init__()
        self.nblocks = nblocks
        for i in range(nblocks):
            self.add_module(f"b{i}_conv1", ConvBnLeaky(channels,
                                                       channels // 2, 1))
            self.add_module(f"b{i}_conv2", ConvBnLeaky(channels // 2,
                                                       channels, 3))

    def forward(self, x):
        for i in range(self.nblocks):
            y = getattr(self, f"b{i}_conv1")(x)
            x = x + getattr(self, f"b{i}_conv2")(y)
        return x


class DarkNet53(nn.Module):
    """Darknet-53 (yolov3.py:67-96) on the NHWC volume of `in_channels`;
    use_bfm_stem replaces the first group by the BFM stem `layer_1` (64
    out, which already downsamples 2x; its dropout `dropout_rate` in
    training). Returns (c3, c4, c5) NCHW at strides 8, 16, 32."""

    def __init__(self, in_channels: int, use_bfm_stem: bool = False,
                 act: str = "silu", dropout_rate: float = 0.1):
        super().__init__()
        self.use_bfm_stem = use_bfm_stem
        if use_bfm_stem:
            self.layer_1 = BinsFusionModule(in_channels, 64, ksize=3,
                                            act=act,
                                            dropout_rate=dropout_rate)
        else:
            self.l1_conv1 = ConvBnLeaky(in_channels, 32, 3)
            self.l1_conv2 = ConvBnLeaky(32, 64, 3, 2)
            self.l1_res = ResBlock(64, 1)
        cin = 64
        for lvl, (cout, n) in enumerate(((128, 2), (256, 8), (512, 8),
                                         (1024, 4)), start=2):
            self.add_module(f"l{lvl}_conv", ConvBnLeaky(cin, cout, 3, 2))
            self.add_module(f"l{lvl}_res", ResBlock(cout, n))
            cin = cout

    def forward(self, x):
        """x: (N, H, W, C) → [c3, c4, c5]."""
        if self.use_bfm_stem:
            c = self.layer_1(x)
        else:
            c = self.l1_res(self.l1_conv2(self.l1_conv1(
                x.permute(0, 3, 1, 2))))
        outs = []
        for lvl in range(2, 6):
            c = getattr(self, f"l{lvl}_res")(getattr(self, f"l{lvl}_conv")(c))
            outs.append(c)
        return outs[1:]


def upsample_bilinear_2x_aligned(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x bilinear upsample with align_corners=True (yolov3.py:95-115:
    src = dst * (in - 1) / (out - 1))."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class _ConvSet5(nn.Module):
    """5 alternating 1x1 / 3x3 leaky convs (yolov3.py:118-131)."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        f = filters
        self.c0 = ConvBnLeaky(in_channels, f, 1)
        self.c1 = ConvBnLeaky(f, f * 2, 3)
        self.c2 = ConvBnLeaky(f * 2, f, 1)
        self.c3 = ConvBnLeaky(f, f * 2, 3)
        self.c4 = ConvBnLeaky(f * 2, f, 1)

    def forward(self, x):
        return self.c4(self.c3(self.c2(self.c1(self.c0(x)))))


class YOLOv3FPN(nn.Module):
    """conv-set + upsample-concat FPN over Darknet-53's (256, 512, 1024)
    (yolov3.py:134-150); returns (p3, p4, p5) of (128, 256, 512)."""

    def __init__(self):
        super().__init__()
        self.conv_set_3 = _ConvSet5(1024, 512)
        self.conv_1x1_3 = ConvBnLeaky(512, 256, 1)
        self.conv_set_2 = _ConvSet5(512 + 256, 256)
        self.conv_1x1_2 = ConvBnLeaky(256, 128, 1)
        self.conv_set_1 = _ConvSet5(256 + 128, 128)

    def forward(self, features):
        c3, c4, c5 = features
        p5 = self.conv_set_3(c5)
        p4 = self.conv_set_2(torch.cat(
            [c4, upsample_bilinear_2x_aligned(self.conv_1x1_3(p5))], 1))
        p3 = self.conv_set_1(torch.cat(
            [c3, upsample_bilinear_2x_aligned(self.conv_1x1_2(p4))], 1))
        return p3, p4, p5


class YOLOv3Head(nn.Module):
    """One 3x3 conv + a 1x1 det conv per level (yolov3.py:153-181); NHWC
    maps out. The det convs' bias starts at the focal prior on the first
    KA (objectness) channels only (`init_prior_bias_`)."""

    def __init__(self, num_classes: int, num_anchors: int = 3,
                 prior_prob: float = 1e-2):
        super().__init__()
        self.num_anchors = num_anchors
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        out_ch = num_anchors * (1 + num_classes + 4)
        self.head_conv_1 = ConvBnLeaky(512, 1024, 3)
        self.head_conv_3 = ConvBnLeaky(256, 512, 3)
        self.head_conv_4 = ConvBnLeaky(128, 256, 3)
        self.head_det_1 = nn.Conv2d(256, out_ch, 1)
        self.head_det_2 = nn.Conv2d(512, out_ch, 1)
        self.head_det_3 = nn.Conv2d(1024, out_ch, 1)

    def init_prior_bias_(self) -> None:
        with torch.no_grad():
            for k in (1, 2, 3):
                bias = getattr(self, f"head_det_{k}").bias
                bias.zero_()
                bias[:self.num_anchors] = self.prior_bias

    def forward(self, features):
        p3, p4, p5 = features
        pred_s = self.head_det_1(self.head_conv_4(p3))
        pred_m = self.head_det_2(self.head_conv_3(p4))
        pred_l = self.head_det_3(self.head_conv_1(p5))
        return [p.permute(0, 2, 3, 1) for p in (pred_s, pred_m, pred_l)]


class YOLOv3Detector(nn.Module):
    """DarkNet-53 → FPN → anchor head (yolov3.py:184-195): the NHWC volume
    in, raw NHWC maps at strides 8, 16, 32 out."""

    def __init__(self, num_classes: int, in_channels: int = 16,
                 use_bfm_stem: bool = False, act: str = "silu",
                 dropout_rate: float = 0.1):
        super().__init__()
        self.backbone = DarkNet53(in_channels, use_bfm_stem, act,
                                  dropout_rate)
        self.neck = YOLOv3FPN()
        self.head = YOLOv3Head(num_classes)

    def forward(self, x):
        x = x.to(next(self.parameters()).dtype)
        return self.head(self.neck(self.backbone(x)))


# ---------------------------------------------------------------------------
# decode / losses
# ---------------------------------------------------------------------------

def split_level_outputs(preds, num_classes: int, num_anchors: int):
    """NHWC maps → per level obj (N, hw*KA, 1), cls (N, hw*KA, C) and reg
    (N, hw, KA, 4) (yolov3.py:203-219)."""
    KA, C = num_anchors, num_classes
    objs, clss, regs = [], [], []
    for p in preds:
        n, h, w, _ = p.shape
        objs.append(p[..., :KA].reshape(n, -1, 1))
        clss.append(p[..., KA:KA * (1 + C)].reshape(n, -1, C))
        regs.append(p[..., KA * (1 + C):].reshape(n, h * w, KA, 4))
    return objs, clss, regs


def yolov3_grids(hw_per_level, strides, anchors):
    """Per level (grid_xy (hw, 2), anchor_wh (KA, 2)) numpy arrays
    (yolov3.py:222-230)."""
    anchors = np.asarray(anchors, np.float32).reshape(len(strides), -1, 2)
    out = []
    for (h, w), s, aw in zip(hw_per_level, strides, anchors):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
        out.append((grid, aw))
    return out


def decode_boxes(preds, num_classes: int, img_size: int,
                 num_anchors: int = 3, strides=STRIDES,
                 anchors=ANCHOR_SIZE2):
    """Raw maps → (obj (N, A, 1), cls (N, A, C), xyxy boxes (N, A, 4) over
    img_size) (yolov3.py:233-253)."""
    objs, clss, regs = split_level_outputs(preds, num_classes, num_anchors)
    hw = [(p.shape[1], p.shape[2]) for p in preds]
    boxes = []
    for reg, (grid, aw), s in zip(regs, yolov3_grids(hw, strides, anchors),
                                  strides):
        grid = torch.from_numpy(grid).to(reg.device)
        aw = torch.from_numpy(aw).to(reg.device)
        xy = (torch.sigmoid(reg[..., :2]) + grid[None, :, None, :]) * s
        wh = torch.exp(reg[..., 2:]) * aw[None, None, :, :]
        boxes.append(torch.cat([xy - wh * 0.5, xy + wh * 0.5], -1)
                     .reshape(reg.shape[0], -1, 4))
    return (torch.cat(objs, 1), torch.cat(clss, 1),
            torch.cat(boxes, 1) / img_size)


def _area(wh: torch.Tensor) -> torch.Tensor:
    """w * h of (..., 2): jnp.prod over the last axis, as one product
    (torch.prod's backward runs a cumprod, 37 ms a step of yolov3_taf_bfm
    at batch 64 on an H100)."""
    return wh[..., 0] * wh[..., 1]


def giou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned (..., 4) xyxy boxes (yolov3.py:256-273)."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    area_a = _area(a[..., 2:] - a[..., :2])
    area_b = _area(b[..., 2:] - b[..., :2])
    en = (tl < br).all(-1).to(a.dtype)
    area_i = _area(br - tl) * en
    area_u = area_a + area_b - area_i
    iou = torch.clamp(area_i / (area_u + 1e-14), min=0.0)
    ctl = torch.minimum(a[..., :2], b[..., :2])
    cbr = torch.maximum(a[..., 2:], b[..., 2:])
    cen = (ctl < cbr).all(-1).to(a.dtype)
    area_c = _area(cbr - ctl) * cen
    giou = iou - (area_c - area_u) / torch.clamp(area_c, min=1e-14)
    return torch.clamp(giou, -1.0, 1.0)


def gt_creator(img_size: int, strides, labels: np.ndarray,
               anchor_size=ANCHOR_SIZE2,
               multi_anchor: bool = False) -> np.ndarray:
    """Host-side per-cell anchor assignment (yolov3.py:276-318), numpy.
    labels: (B, G, 5) rows [class, cx, cy, w, h] in pixels (zero rows are
    padding). Returns (B, A_total, 7) f32 rows [obj, cls, x1, y1, x2, y2,
    scale], the boxes over img_size, A_total over levels in (y, x, a) order.
    Boxes under 1 px are skipped; the cell is int(centre / stride) on a
    square grid of img_size // stride cells. multi_anchor assigns every
    anchor of wh-IoU > 0.5 (the single best when none is)."""
    labels = np.asarray(labels)
    B = labels.shape[0]
    KA = len(anchor_size) // len(strides)
    anchors = np.asarray(anchor_size, np.float64)
    gt = [np.zeros((B, img_size // s, img_size // s, KA, 7)) for s in strides]

    for bi in range(B):
        for row in labels[bi]:
            if row.sum() == 0:
                continue
            cls_id = int(row[0])
            xc, yc, bw, bh = row[1:5]
            if bw < 1.0 or bh < 1.0:
                continue
            x1, y1 = (xc - bw / 2) / img_size, (yc - bh / 2) / img_size
            x2, y2 = (xc + bw / 2) / img_size, (yc + bh / 2) / img_size
            scale = 2.0 - (bw / img_size) * (bh / img_size)
            inter = np.minimum(anchors[:, 0], bw) * np.minimum(anchors[:, 1],
                                                              bh)
            union = anchors[:, 0] * anchors[:, 1] + bw * bh - inter + 1e-20
            iou = inter / union
            if multi_anchor and (iou > 0.5).any():
                picks = np.nonzero(iou > 0.5)[0]
            else:
                picks = [int(np.argmax(iou))]
            for idx in picks:
                s_ind, a_ind = idx // KA, idx % KA
                s = strides[s_ind]
                gx, gy = int(xc / s), int(yc / s)
                if (0 <= gy < gt[s_ind].shape[1]
                        and 0 <= gx < gt[s_ind].shape[2]):
                    gt[s_ind][bi, gy, gx, a_ind] = [1.0, cls_id, x1, y1, x2,
                                                    y2, scale]
    flat = [g.reshape(B, -1, 7) for g in gt]
    return np.concatenate(flat, axis=1).astype(np.float32)


def yolov3_loss(preds, gt_tensor: torch.Tensor, num_classes: int,
                img_size: int):
    """The criterion (yolov3.py:321-355): objectness MSE on the sigmoid
    against 0.5 * (GIoU + 1) at positives (detached; pos 5x, neg 1x), CE
    at positives, (1 - GIoU) * scale at positives, each summed over the
    batch / N. gt_tensor from `gt_creator`. Under a process group N is
    the global batch (world() equal shards), so each rank's losses are its
    share of the global ones."""
    obj_pred, cls_pred, box_pred = decode_boxes(preds, num_classes, img_size)
    target_pos = gt_tensor[..., 0]
    target_cls = gt_tensor[..., 1].long()
    target_box = gt_tensor[..., 2:6]
    target_scale = gt_tensor[..., 6]

    giou = giou_xyxy(box_pred, target_box)
    target_obj = (0.5 * (giou + 1.0)).detach() * target_pos

    B = obj_pred.shape[0] * dist.world()
    mse = torch.square(torch.sigmoid(obj_pred[..., 0]) - target_obj)
    loss_obj = (mse * (target_pos * 5.0 + (1 - target_pos))).sum() / B

    logp = torch.log_softmax(cls_pred, dim=-1)
    ce = -torch.gather(logp, -1, target_cls[..., None])[..., 0]
    loss_cls = (ce * target_pos).sum() / B

    loss_reg = ((1.0 - giou) * target_scale * target_pos).sum() / B
    return {"total_loss": loss_obj + loss_cls + loss_reg,
            "obj_loss": loss_obj, "cls_loss": loss_cls, "iou_loss": loss_reg}


def yolov3_eval_decode(preds, num_classes: int, img_size: int):
    """→ (N, A, 5 + C) rows [cx, cy, w, h, conf, cls / conf] in pixels for
    postprocess_batch (yolov3.py:358-363): score sigmoid(obj) *
    softmax(cls), boxes clamped to the frame."""
    obj, cls, box = decode_boxes(preds, num_classes, img_size)
    box = torch.clamp(box, 0.0, 1.0) * img_size
    cx = (box[..., 0] + box[..., 2]) / 2
    cy = (box[..., 1] + box[..., 3]) / 2
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    scores = torch.sigmoid(obj[..., 0:1]) * torch.softmax(cls, dim=-1)
    conf = scores.max(-1, keepdim=True).values
    cls_probs = scores / torch.clamp(conf, min=1e-12)
    return torch.cat([torch.stack([cx, cy, w, h], -1), conf, cls_probs], -1)
