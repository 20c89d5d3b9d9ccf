"""RED, the recurrent event detector (counterpart of
frlw_evd_tpu/models/red.py): an SE-ResNet backbone (7x7 stem + 3
SE-bottlenecks, 16x down), 5 stacked stride-2 ConvLSTMs making the SSD
pyramid, and the SSD box head with its priors, variance coding,
hard-negative-mined focal / smooth-L1 MultiBox loss and per-prior decode.

The network runs NCHW inside; `REDDetector` takes the NHWC volume and the
carries in the JAX layout (NHWC (h, c) pairs) and returns them so. The
loss is batched over the samples where JAX vmaps it; the prior
assignment's forced matches are a deterministic last-wins scatter.
"""

from __future__ import annotations

import math
from itertools import product

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist
from .blocks import BatchNorm2d, PromotingConv2d
from .memory import ConvLSTMCell, carries_nchw, carries_nhwc

CENTER_VARIANCE = 0.1
SIZE_VARIANCE = 0.2
IOU_THRESHOLD = 0.5
NEG_POS_RATIO = 3
CONFIDENCE_THRESHOLD = 0.01
NMS_THRESHOLD = 0.45
TOPK = 15
HIDDEN = 256


# ---------------------------------------------------------------------------
# network
# ---------------------------------------------------------------------------

class SEBottleneck(nn.Module):
    """3 x conv-bn(-relu) + SE gate + a 1x1 downsample residual
    (red.py:42-73); submodules `{c1,c2,c3,down}_{conv,bn}`, `conv_down`,
    `conv_up`."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        for name, cin, k, s in (("c1", in_channels, 3, 1),
                                ("c2", planes, 3, stride),
                                ("c3", planes, 3, 1),
                                ("down", in_channels, 1, stride)):
            self.add_module(f"{name}_conv", nn.Conv2d(
                cin, planes, k, s, (k - 1) // 2, bias=False))
            self.add_module(f"{name}_bn", BatchNorm2d(planes, eps=1e-5))
        self.conv_down = nn.Conv2d(planes, planes // 4, 1, bias=False)
        self.conv_up = nn.Conv2d(planes // 4, planes, 1, bias=False)

    def _conv_bn(self, name, x):
        return getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))

    def forward(self, x):
        out = F.relu(self._conv_bn("c1", x))
        out = F.relu(self._conv_bn("c2", out))
        out = self._conv_bn("c3", out)
        se = out.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.conv_up(F.relu(self.conv_down(se))))
        return se * out + self._conv_bn("down", x)


class SEResNet(nn.Module):
    """7x7/2 stem + 3 SE bottlenecks (red.py:76-89): 128 channels at
    stride 16."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(32, eps=1e-5)
        self.layer1 = SEBottleneck(32, 64, 2)
        self.layer2 = SEBottleneck(64, 64, 2)
        self.layer3 = SEBottleneck(64, 128, 2)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class MemoryLayers(nn.Module):
    """5 stacked stride-2 ConvLSTMs `lstms_{i}` → the SSD pyramid
    (red.py:92-119)."""

    def __init__(self, in_channels: int = 128, hidden: int = HIDDEN):
        super().__init__()
        for i in range(5):
            self.add_module(f"lstms_{i}", ConvLSTMCell(
                in_channels if i == 0 else hidden, hidden, 3, 2))

    def forward(self, carries, x):
        new_carries, outputs = [], []
        for i, carry in enumerate(carries):
            carry, x = getattr(self, f"lstms_{i}")(carry, x)
            new_carries.append(carry)
            outputs.append(x)
        return tuple(new_carries), outputs


class SSDBoxPredictor(nn.Module):
    """Per-level 3x3 cls / reg heads `cls_{k}`, `reg_{k}` (red.py:122-136);
    num_classes includes the background. The maps go NHWC before the
    reshape to (n, -1, C) / (n, -1, 4), so a prior is (y, x, box)."""

    def __init__(self, num_classes: int, in_channels: int = HIDDEN,
                 boxes_per_location=(6, 6, 6, 4, 4)):
        super().__init__()
        self.num_classes = num_classes
        for k, bpl in enumerate(boxes_per_location):
            self.add_module(f"cls_{k}", PromotingConv2d(
                in_channels, bpl * num_classes, 3, padding=1))
            self.add_module(f"reg_{k}", PromotingConv2d(
                in_channels, bpl * 4, 3, padding=1))

    def forward(self, features):
        cls_logits, bbox_pred = [], []
        for k, feat in enumerate(features):
            n = feat.shape[0]
            c = getattr(self, f"cls_{k}")(feat).permute(0, 2, 3, 1)
            r = getattr(self, f"reg_{k}")(feat).permute(0, 2, 3, 1)
            cls_logits.append(c.reshape(n, -1, self.num_classes))
            bbox_pred.append(r.reshape(n, -1, 4))
        return torch.cat(cls_logits, 1), torch.cat(bbox_pred, 1)


class REDDetector(nn.Module):
    """SEResNet → MemoryLayers → SSD predictor (red.py:139-169), one window
    step: forward(carries, x) → (carries, (cls_logits, bbox_pred)), x the
    NHWC volume, the carries a tuple of 5 NHWC (h, c) pairs
    (`init_carries`). The ConvLSTMs compute in the wider of the carry's
    and the weights' dtypes, as flax promotes: from f32 carries on, a bf16
    step computes in f32, as JAX's does."""

    def __init__(self, num_classes: int, in_channels: int = 16):
        super().__init__()
        self.backbone = SEResNet(in_channels)
        self.memory = MemoryLayers()
        self.predictor = SSDBoxPredictor(num_classes + 1)

    def forward(self, carries, x):
        x = x.to(next(self.parameters()).dtype).permute(0, 3, 1, 2)
        carries, pyramid = self.memory(carries_nchw(carries),
                                       self.backbone(x))
        return carries_nhwc(carries), self.predictor(pyramid)

    @staticmethod
    def init_carries(n, h, w, dtype=torch.float32, device=None):
        """Zero NHWC carries for an (h, w) input: the backbone's 16x (ceil),
        then each ConvLSTM halves (ceil) (red.py:161-169)."""
        return tuple((torch.zeros((n, fy, fx, HIDDEN), dtype=dtype,
                                  device=device),
                      torch.zeros((n, fy, fx, HIDDEN), dtype=dtype,
                                  device=device))
                     for fy, fx in pyramid_shapes(h, w))


# ---------------------------------------------------------------------------
# priors / coding (numpy priors; torch coding)
# ---------------------------------------------------------------------------

def pyramid_shapes(height: int, width: int):
    """The (fy, fx) sizes of the 5 ConvLSTM pyramid levels
    (red.py:176-183)."""
    hh, ww = (height + 15) // 16, (width + 15) // 16
    out = []
    for _ in range(5):
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
        out.append((hh, ww))
    return out


def build_priors(height: int, width: int) -> np.ndarray:
    """SSD priors (P, 4) f32 in center form, relative, clipped to [0, 1]
    (red.py:186-219): the grids of the pyramid's real sizes, the
    reference's sizes and aspect ratios."""
    maps = pyramid_shapes(height, width)
    expand = height / 256
    min_sizes = [s * expand for s in (10, 62, 114, 166, 218)]
    max_sizes = [s * expand for s in (62, 114, 166, 218, 270)]
    aspect_ratios = [[2, 3], [2, 3], [2, 3], [2], [2]]

    priors = []
    for k, (f_y, f_x) in enumerate(maps):
        for i, j in product(range(f_y), range(f_x)):
            cx = (j + 0.5) / f_x
            cy = (i + 0.5) / f_y
            size = min_sizes[k]
            priors.append([cx, cy, size / width, size / height])
            size = math.sqrt(min_sizes[k] * max_sizes[k])
            priors.append([cx, cy, size / width, size / height])
            size = min_sizes[k]
            w, h = size / width, size / height
            for ratio in aspect_ratios[k]:
                r = math.sqrt(ratio)
                priors.append([cx, cy, w * r, h / r])
                priors.append([cx, cy, w / r, h * r])
    return np.clip(np.array(priors, np.float32), 0.0, 1.0)


def center_to_corner(b):
    return torch.cat([b[..., :2] - b[..., 2:] / 2,
                      b[..., :2] + b[..., 2:] / 2], -1)


def corner_to_center(b):
    return torch.cat([(b[..., :2] + b[..., 2:]) / 2,
                      b[..., 2:] - b[..., :2]], -1)


def locations_to_boxes(locations, priors):
    """Variance decoding (red.py:232-237)."""
    return torch.cat([
        locations[..., :2] * CENTER_VARIANCE * priors[..., 2:]
        + priors[..., :2],
        torch.exp(locations[..., 2:] * SIZE_VARIANCE) * priors[..., 2:],
    ], -1)


def boxes_to_locations(boxes, priors):
    """Variance coding (red.py:240-245)."""
    return torch.cat([
        (boxes[..., :2] - priors[..., :2]) / priors[..., 2:]
        / CENTER_VARIANCE,
        torch.log(torch.clamp(boxes[..., 2:] / priors[..., 2:], min=1e-8))
        / SIZE_VARIANCE,
    ], -1)


def iou_corner(a, b):
    """(..., 4) corner-form IoU with broadcast (red.py:248-256)."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0))
    return inter / (area(a) + area(b) - inter + 1e-5)


# ---------------------------------------------------------------------------
# matching / loss
# ---------------------------------------------------------------------------

def assign_priors(gt_corner, gt_labels, gt_valid, priors_corner):
    """Prior assignment over a batch (red.py:259-277, vmapped there).

    gt_corner (N, G, 4) relative corner boxes, gt_labels (N, G) 1-based
    (0 = background), gt_valid (N, G) bool, priors_corner (P, 4). Returns
    (boxes (N, P, 4) corner, labels (N, P) int32). Each valid target is
    forced onto its best prior; where two targets share a best prior the
    later one wins, as the reference's loop and XLA's ordered scatter
    have it (a scatter-max of the target index, deterministic on the
    card). Padded targets are dropped."""
    ious = iou_corner(gt_corner[:, None, :, :],
                      priors_corner[None, :, None, :])          # (N, P, G)
    ious = torch.where(gt_valid[:, None, :], ious, -1.0)
    best_target_per_prior, best_target_idx = ious.max(2)
    best_prior_per_target = ious.argmax(1)                      # (N, G)
    g_idx = torch.arange(gt_corner.shape[1], device=gt_corner.device)
    forced = torch.full_like(best_target_idx, -1).scatter_reduce(
        1, best_prior_per_target,
        torch.where(gt_valid, g_idx, -1).expand_as(best_prior_per_target),
        "amax")
    hit = forced >= 0
    best_target_idx = torch.where(hit, forced, best_target_idx)
    best_target_per_prior = torch.where(
        hit, torch.full_like(best_target_per_prior, 2.0),
        best_target_per_prior)
    labels = torch.gather(gt_labels, 1, best_target_idx)
    labels = torch.where(best_target_per_prior < IOU_THRESHOLD, 0, labels)
    boxes = torch.gather(gt_corner, 1,
                         best_target_idx[..., None].expand(-1, -1, 4))
    return boxes, labels.to(torch.int32)


def hard_negative_mining(loss, labels, neg_pos_ratio):
    """(N, P) background losses → the mask of positives and the
    neg_pos_ratio x as many highest-loss negatives (red.py:280-289). Both
    argsorts are stable, as jnp.argsort is, so tied losses rank by index."""
    pos_mask = labels > 0
    num_neg = pos_mask.sum(dim=1, keepdim=True) * neg_pos_ratio
    loss = torch.where(pos_mask, -math.inf, loss)
    order = torch.argsort(-loss, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return pos_mask | (ranks < num_neg)


def multibox_loss(cls_logits, bbox_pred, labels, gt_locations,
                  gamma: float = 2.0):
    """Hard-negative-mined focal classification + smooth-L1 regression
    (red.py:292-317); labels (N, P) int (0 = background). Returns
    (reg_loss, cls_loss), both over the number of positives. Under a
    process group the mined and positive counts are the global batch's,
    clamped there."""
    with torch.no_grad():
        bg_loss = -torch.log_softmax(cls_logits, dim=2)[:, :, 0]
        mask = hard_negative_mining(bg_loss, labels, NEG_POS_RATIO)

    probs = torch.softmax(cls_logits, dim=-1)
    p_t = torch.gather(probs, -1, labels.long()[..., None])[..., 0]
    log_p = torch.log(torch.clamp(p_t, min=1e-12))
    focal = -torch.pow(1.0 - p_t, gamma) * log_p
    n_mined = torch.clamp(dist.global_sum(mask.sum()), min=1)
    cls_loss = (focal * mask).sum() / n_mined

    pos = labels > 0
    diff = bbox_pred - gt_locations
    abs_diff = torch.abs(diff)
    smooth_l1 = torch.where(abs_diff < 1.0, 0.5 * diff ** 2,
                            abs_diff - 0.5).sum(-1)
    num_pos = torch.clamp(dist.global_sum(pos.sum()), min=1)
    reg_loss = (smooth_l1 * pos).sum() / num_pos
    cls_loss = cls_loss * n_mined / num_pos
    return reg_loss, cls_loss


def red_loss(cls_logits, bbox_pred, labels_batch, height, width, priors):
    """The training loss from padded labels (N, G, 5) [class, cx, cy, w, h]
    in pixels (red.py:320-337); priors: build_priors' (P, 4)."""
    priors_c = torch.as_tensor(priors, device=cls_logits.device)
    labels_batch = labels_batch.to(cls_logits.device)
    valid = labels_batch.sum(-1) > 0
    scale = torch.tensor([width, height, width, height],
                         device=labels_batch.device)
    corner = center_to_corner(labels_batch[..., 1:5] / scale)
    cls = labels_batch[..., 0].to(torch.int32) + 1
    gt_boxes, labels = assign_priors(corner, cls, valid,
                                     center_to_corner(priors_c))
    locations = boxes_to_locations(corner_to_center(gt_boxes), priors_c)
    reg_loss, cls_loss = multibox_loss(cls_logits, bbox_pred, labels,
                                       locations)
    return {"total_loss": reg_loss + cls_loss, "iou_loss": reg_loss,
            "cls_loss": cls_loss}


def red_eval_decode(cls_logits, bbox_pred, priors, height, width):
    """→ (N, P, 5 + C) rows [cx, cy, w, h, conf, cls / conf] in pixels for
    postprocess_batch (red.py:340-348); the caller applies conf 0.01, NMS
    0.45 and the top 15."""
    priors_c = torch.as_tensor(priors, device=cls_logits.device)
    scores = torch.softmax(cls_logits, dim=2)[..., 1:]
    boxes = locations_to_boxes(bbox_pred, priors_c[None])
    boxes = boxes * torch.tensor([width, height, width, height],
                                 device=boxes.device)
    conf = scores.max(-1, keepdim=True).values
    cls_probs = scores / torch.clamp(conf, min=1e-12)
    return torch.cat([boxes, conf, cls_probs], -1)
