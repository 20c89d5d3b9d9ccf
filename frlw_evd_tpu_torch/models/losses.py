"""Loss primitives (counterpart of frlw_evd_tpu/models/losses.py).

The formulas are the JAX package's, epsilons and all: torchvision's box
ops differ in the epsilon and in the gradient where boxes do not overlap.
The areas are w * h written out, where JAX takes jnp.prod over the last
two coordinates: the same value and, unlike the backward of torch's prod
(a division, and a cumprod on the card), the same gradient. All functions
are elementwise or fixed-shape and make no host sync.
"""

from __future__ import annotations

import torch


def pairwise_iou_cxcywh(boxes_a: torch.Tensor,
                        boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., G, 4) and (..., A, 4) cxcywh boxes → (..., G, A)
    (losses.py:12-25), over any leading batch dimensions."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    en = torch.all(tl < br, dim=-1).to(boxes_a.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    return area_i / (area_a + area_b - area_i + 1e-12)


def iou_elementwise_cxcywh(pred: torch.Tensor,
                           target: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU between aligned (N, 4) cxcywh boxes
    (losses.py:28-36)."""
    tl = torch.maximum(pred[:, :2] - pred[:, 2:] / 2,
                       target[:, :2] - target[:, 2:] / 2)
    br = torch.minimum(pred[:, :2] + pred[:, 2:] / 2,
                       target[:, :2] + target[:, 2:] / 2)
    area_p = pred[:, 2] * pred[:, 3]
    area_g = target[:, 2] * target[:, 3]
    en = torch.all(tl < br, dim=1).to(pred.dtype)
    wh = br - tl
    area_i = wh[:, 0] * wh[:, 1] * en
    return area_i / (area_p + area_g - area_i + 1e-16)


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - iou^2 per row (losses.py:39-42)."""
    return 1.0 - iou_elementwise_cxcywh(pred, target) ** 2


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, no reduction (losses.py:45-47)."""
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on probabilities with the -100 log clamp
    (losses.py:50-54)."""
    logp = torch.clamp_min(torch.log(probs), -100.0)
    log1mp = torch.clamp_min(torch.log1p(-probs), -100.0)
    return -(targets * logp + (1.0 - targets) * log1mp)
