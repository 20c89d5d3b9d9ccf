"""Host-side demo post-processing (counterpart of
frlw_evd_tpu/utils/demo_utils.py; reference core/yolox/utils/
demo_utils.py and boxes.py): single- and multi-class NMS and the box
format converters, on torch tensors, for deployment paths that run
without the batched pipeline."""

from __future__ import annotations

import torch


def nms(boxes: torch.Tensor, scores: torch.Tensor, nms_thr: float) -> list:
    """Single-class NMS on (N, 4) xyxy boxes: the indices kept, highest
    score first. Areas and overlaps count the +1 pixel (demo_utils.py:13,
    23-24). The order is numpy's default argsort of the scores, reversed,
    as the JAX function takes it: numpy's default sort is not stable (it
    sorts floats with SIMD code), so equal scores keep the order it gives
    them only when the sort is numpy's own."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = torch.from_numpy(
        scores.detach().cpu().numpy().argsort()[::-1].copy()).to(
            boxes.device)
    keep = []
    while order.numel() > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx1 = torch.maximum(x1[i], x1[rest])
        yy1 = torch.maximum(y1[i], y1[rest])
        xx2 = torch.minimum(x2[i], x2[rest])
        yy2 = torch.minimum(y2[i], y2[rest])
        w = torch.clamp_min(xx2 - xx1 + 1, 0.0)
        h = torch.clamp_min(yy2 - yy1 + 1, 0.0)
        inter = w * h
        ovr = inter / (areas[i] + areas[rest] - inter)
        order = rest[ovr <= nms_thr]
    return keep


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, nms_thr: float,
                   score_thr: float, class_agnostic: bool = False):
    """(N, 4) boxes x (N, C) scores → (n, 6) [x1, y1, x2, y2, score, cls],
    or None when nothing passes (demo_utils.py:31-60)."""
    if class_agnostic:
        cls_inds = scores.argmax(1)
        cls_scores = scores[torch.arange(len(cls_inds)), cls_inds]
        valid = cls_scores > score_thr
        if not bool(valid.any()):
            return None
        vb, vs, vc = boxes[valid], cls_scores[valid], cls_inds[valid]
        keep = nms(vb, vs, nms_thr)
        if not keep:
            return None
        return torch.cat([vb[keep], vs[keep, None],
                          vc[keep, None].to(vb.dtype)], 1)
    final = []
    for cls_ind in range(scores.shape[1]):
        cls_scores = scores[:, cls_ind]
        valid = cls_scores > score_thr
        if not bool(valid.any()):
            continue
        vb, vs = boxes[valid], cls_scores[valid]
        keep = nms(vb, vs, nms_thr)
        if keep:
            cls_col = torch.full((len(keep), 1), float(cls_ind),
                                 dtype=torch.float32, device=vb.device)
            final.append(torch.cat([vb[keep], vs[keep, None],
                                    cls_col.to(vb.dtype)], 1))
    if not final:
        return None
    return torch.cat(final, 0)


def xyxy2xywh(bboxes: torch.Tensor) -> torch.Tensor:
    out = bboxes.clone()
    out[:, 2] = bboxes[:, 2] - bboxes[:, 0]
    out[:, 3] = bboxes[:, 3] - bboxes[:, 1]
    return out


def xyxy2cxcywh(bboxes: torch.Tensor) -> torch.Tensor:
    out = bboxes.clone()
    out[:, 2] = bboxes[:, 2] - bboxes[:, 0]
    out[:, 3] = bboxes[:, 3] - bboxes[:, 1]
    out[:, 0] = bboxes[:, 0] + out[:, 2] * 0.5
    out[:, 1] = bboxes[:, 1] + out[:, 3] * 0.5
    return out


def cxcywh2xyxy(bboxes: torch.Tensor) -> torch.Tensor:
    out = bboxes.clone()
    out[:, 0] = bboxes[:, 0] - bboxes[:, 2] * 0.5
    out[:, 1] = bboxes[:, 1] - bboxes[:, 3] * 0.5
    out[:, 2] = bboxes[:, 0] + bboxes[:, 2] * 0.5
    out[:, 3] = bboxes[:, 1] + bboxes[:, 3] * 0.5
    return out
