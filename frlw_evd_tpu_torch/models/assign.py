"""SimOTA dynamic-k label assignment over a batch, in fixed shapes
(counterpart of frlw_evd_tpu/models/assign.py).

The JAX package assigns one image and maps it over the batch with
`jax.vmap` (heads.py:225); here the batch is a leading dimension N written
out. Shapes are fixed and nothing syncs with the host, so the assignment
runs inside a train step. Tie-breaking follows JAX's:
  * `jax.lax.top_k` puts the lower index first among equal values: the
    per-gt pick is a stable ascending sort of the cost (torch.topk leaves
    the order of ties unspecified);
  * argmin and argmax return the first occurrence, as torch's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .losses import pairwise_iou_cxcywh

BIG_COST = 1e9
CENTER_PENALTY = 100000.0
CANDIDATE_K = 10


class Assignment(NamedTuple):
    fg_mask: torch.Tensor      # (N, A) bool, the anchor is a positive
    matched_gt: torch.Tensor   # (N, A) int64, its gt (0 off the foreground)
    matched_cls: torch.Tensor  # (N, A) int64
    pred_iou: torch.Tensor     # (N, A) float, IoU with the matched gt
    num_fg: torch.Tensor       # (N,) float
    num_gt: torch.Tensor       # (N,) float


def get_geometry_constraints(gt_boxes, gt_valid, anchor_xc, anchor_yc,
                             anchor_stride, radius):
    """(N, G, A) in-box and in-centre masks and the (N, A) candidate mask
    (assign.py:40-63). gt_boxes (N, G, 4) cxcywh, gt_valid (N, G); the
    anchor tensors are (A,)."""
    gx, gy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]
    xc, yc = anchor_xc[None, None, :], anchor_yc[None, None, :]

    b_l = xc - (gx - 0.5 * gw)
    b_r = (gx + 0.5 * gw) - xc
    b_t = yc - (gy - 0.5 * gh)
    b_b = (gy + 0.5 * gh) - yc
    in_box = torch.minimum(torch.minimum(b_l, b_r),
                           torch.minimum(b_t, b_b)) > 0.0

    r = radius * anchor_stride[None, None, :]
    c_l = xc - (gx - r)
    c_r = (gx + r) - xc
    c_t = yc - (gy - r)
    c_b = (gy + r) - yc
    in_center = torch.minimum(torch.minimum(c_l, c_r),
                              torch.minimum(c_t, c_b)) > 0.0

    in_box = in_box & gt_valid[..., None]
    in_center = in_center & gt_valid[..., None]
    candidate = in_box.any(dim=1) | in_center.any(dim=1)         # (N, A)
    return in_box, in_center, candidate


@torch.no_grad()
def simota_assign(gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
                  cls_logits, anchor_xc, anchor_yc, anchor_stride, radius,
                  *, num_classes: int) -> Assignment:
    """Assign a batch of images (assign.py:66-137). No gradient flows
    through the assignment.

    Args:
      gt_boxes: (N, G, 4) cxcywh (padded rows arbitrary).
      gt_classes: (N, G) int64 in [0, num_classes).
      gt_valid: (N, G) bool.
      pred_boxes: (N, A, 4) decoded cxcywh.
      obj_logits: (N, A) raw. cls_logits: (N, A, C) raw.
      anchor_xc/yc: (A,) anchor centres in pixels; anchor_stride: (A,).
      radius: centre radius (5 for GEN1, 2.5 for GEN4).
    """
    N, G = gt_boxes.shape[:2]
    A = pred_boxes.shape[1]

    in_box, in_center, candidate = get_geometry_constraints(
        gt_boxes, gt_valid, anchor_xc, anchor_yc, anchor_stride, radius)

    ious = pairwise_iou_cxcywh(gt_boxes, pred_boxes)              # (N, G, A)
    iou_cost = -torch.log(ious + 1e-8)

    # BCE(sqrt(cls_sig * obj_sig), onehot) summed over C, decomposed as in
    # the JAX package: an (A,) row sum plus an (A, C) correction table
    # gathered at the gt class, so no (G, A, C) tensor exists
    cls_prob = torch.sqrt(torch.sigmoid(cls_logits)
                          * torch.sigmoid(obj_logits)[..., None])  # (N, A, C)
    logp = torch.clamp_min(torch.log(cls_prob), -100.0)
    log1mp = torch.clamp_min(torch.log1p(-cls_prob), -100.0)
    all_neg = (-log1mp).sum(-1)                                   # (N, A)
    corr = (log1mp - logp).transpose(1, 2)                        # (N, C, A)
    cls_cost = all_neg[:, None, :] + torch.gather(
        corr, 1, gt_classes[..., None].expand(N, G, A))           # (N, G, A)

    cost = (cls_cost + 3.0 * iou_cost
            + CENTER_PENALTY * (~(in_box & in_center))
            + BIG_COST * (~candidate)[:, None, :]
            + BIG_COST * (~gt_valid)[..., None])

    # dynamic k per gt: IoUs outside the candidate set contribute nothing
    k = min(CANDIDATE_K, A)
    masked_ious = torch.where(candidate[:, None, :] & gt_valid[..., None],
                              ious, 0.0)
    topk_ious = torch.topk(masked_ious, k, dim=-1).values
    dynamic_ks = torch.clamp_min(topk_ious.sum(-1).to(torch.int32), 1)

    # per-gt pick of the k lowest-cost anchors, ties to the lower index
    sorted_cost, order = torch.sort(cost, dim=-1, stable=True)
    pick_cost, pick_idx = sorted_cost[..., :k], order[..., :k]
    rank = torch.arange(k, device=cost.device)
    picked = (rank < dynamic_ks[..., None]) & (pick_cost < BIG_COST / 2)
    # the k picks of a gt are distinct anchors, so a plain scatter equals
    # JAX's .at[].max
    matching = torch.zeros(N, G, A, dtype=torch.bool, device=cost.device)
    matching.scatter_(2, pick_idx, picked)

    # anchors matched to several gts keep the min-cost gt
    multi = matching.sum(1) > 1                                   # (N, A)
    best_gt = torch.argmin(cost, dim=1)                           # (N, A)
    best_onehot = F.one_hot(best_gt, G).transpose(1, 2).bool()
    matching = torch.where(multi[:, None, :], best_onehot, matching)

    fg_mask = matching.any(1)
    matched_gt = torch.argmax(matching.to(torch.uint8), dim=1)
    matched_cls = torch.gather(gt_classes, 1, matched_gt)
    pred_iou = (matching * ious).sum(1)
    num_fg = fg_mask.sum(-1).to(torch.float32)
    num_gt = gt_valid.sum(-1).to(torch.float32)
    return Assignment(fg_mask, matched_gt, matched_cls, pred_iou, num_fg,
                      num_gt)
