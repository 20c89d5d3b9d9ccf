"""Plain reference of the detector's post-processing: the YOLOX decode
(xy = (pred + grid) * stride, wh = pred^2 * stride, sigmoid obj and cls),
then per image the confidence filter, the top-K candidates by obj score
(ties to the lower anchor) and class-agnostic greedy NMS, in fixed shapes:
dets (N, K, 6) rows [cx, cy, w, h, class, obj * max cls] and keep (N, K).

`dtype` is the precision the decode and the scores are computed in; the
control computes them one step below the configuration's.
"""

from __future__ import annotations

import torch


def decode(level_outs, strides, dtype=torch.float32):
    """Per-level (N, h, w, 5 + C) raw maps → (N, A, 5 + C), anchors level
    by level in row-major (y, x) order."""
    xs, ys, ss, flat = [], [], [], []
    for o, s in zip(level_outs, strides):
        n, h, w, c = o.shape
        yy, xx = torch.meshgrid(torch.arange(h, device=o.device),
                                torch.arange(w, device=o.device),
                                indexing="ij")
        xs.append(xx.reshape(-1))
        ys.append(yy.reshape(-1))
        ss.append(torch.full((h * w,), s, device=o.device))
        flat.append(o.reshape(n, h * w, c))
    x_shift, y_shift, stride = (torch.cat(a).to(dtype) for a in (xs, ys, ss))
    out = torch.cat(flat, 1).to(dtype)
    xy = (out[..., :2] + torch.stack([x_shift, y_shift], -1)) * stride[:, None]
    wh = torch.square(out[..., 2:4]) * stride[:, None]
    return torch.cat([xy, wh, torch.sigmoid(out[..., 4:])], -1)


def _iou(boxes):
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    inter = torch.clamp_min(br - tl, 0.0).prod(-1)
    area = torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0).prod(-1)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def nms(boxes_xyxy, valid, threshold: float):
    """Greedy NMS in score order, one decision a candidate: a candidate is
    kept when valid and no kept earlier one overlaps it by IoU above
    `threshold`."""
    K = boxes_xyxy.shape[-2]
    order = torch.arange(K, device=boxes_xyxy.device)
    edge = (order[:, None] < order[None, :]) & (_iou(boxes_xyxy) > threshold)
    keep = torch.zeros_like(valid)
    for i in range(K):
        keep[..., i] = valid[..., i] & ~(keep & edge[..., :, i]).any(-1)
    return keep


def postprocess(decoded, conf: float, nms_threshold: float,
                max_detections: int):
    boxes, obj, cls = decoded[..., :4], decoded[..., 4], decoded[..., 5:]
    K = min(max_detections, decoded.shape[1])
    scores = torch.where(obj > conf, obj, torch.full_like(obj, -1.0))
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :K], idx[:, :K]
    valid = top > conf
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, idx[..., None].expand(-1, -1,
                                                         cls.shape[-1]))
    half = top_boxes[..., 2:] / 2
    xyxy = torch.cat([top_boxes[..., :2] - half, top_boxes[..., :2] + half],
                     -1)
    keep = nms(xyxy, valid, nms_threshold)
    cls_max, cls_id = top_cls.max(-1)
    dets = torch.cat([top_boxes, cls_id[..., None].to(top_boxes.dtype),
                      (top * cls_max)[..., None]], -1)
    return dets.float(), keep


def detections(level_outs, post: dict, strides, dtype=torch.float32):
    """decode then postprocess with the config's "post" settings."""
    return postprocess(decode(level_outs, strides, dtype), post["conf"],
                       post["nms"], post["max_detections"])
