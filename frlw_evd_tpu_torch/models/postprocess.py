"""Inference post-processing: confidence filter + NMS in fixed shapes
(counterpart of frlw_evd_tpu/models/postprocess.py).

Per image: keep detections with obj > conf, class-agnostic greedy NMS on
obj scores, rows [cx, cy, w, h, argmax_cls, obj * max_cls]. The data-
dependent filter is a top-K selection plus a validity mask, as in the JAX
package, so the outputs have fixed shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count, span


def cxcywh_to_xyxy(boxes):
    half = boxes[..., 2:4] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], -1)


def iou_matrix_xyxy(boxes):
    """(..., K, 4) xyxy → (..., K, K) IoU, union clamped at 1e-12
    (postprocess.py:22-29)."""
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    inter = torch.clamp_min(br - tl, 0.0).prod(-1)
    area = torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0).prod(-1)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def _suppression_edges(boxes_xyxy, iou_threshold):
    """(..., K, K): [j, i] true when earlier box j overlaps box i."""
    K = boxes_xyxy.shape[-2]
    order = torch.arange(K, device=boxes_xyxy.device)
    earlier = order[:, None] < order[None, :]
    return earlier & (iou_matrix_xyxy(boxes_xyxy) > iou_threshold)


def nms_mask(boxes_xyxy, scores, valid, iou_threshold: float):
    """Greedy class-agnostic NMS over boxes sorted by descending score, as
    the fixpoint of keep[i] = valid[i] & ~any_{j<i}(keep[j] & iou[j,i] > t)
    (postprocess.py:32-61). Takes (..., K) batches; iterates until no keep
    flag changes: at most K rounds, each a host sync (`torch.equal`). On the
    benchmark's serving cells (B = 128, K = 100) the `nms_rounds` counter
    reads 14.2-14.8 rounds a step at GEN1 and 13.3-13.7 at 1 Mpx on
    average, 10-16 in single steps."""
    sup_edge = _suppression_edges(boxes_xyxy, iou_threshold)
    keep = valid
    for _ in range(boxes_xyxy.shape[-2]):
        with span("serve.nms_round", events=False):
            count("nms_rounds")
            new = valid & ~(sup_edge & keep[..., :, None]).any(dim=-2)
            with span("host_sync", events=False):
                count("host_syncs")
                same = torch.equal(new, keep)
        if same:
            break
        keep = new
    return keep


def nms_mask_rounds(boxes_xyxy, scores, valid, iou_threshold: float):
    """`nms_mask` without its early exit: exactly K rounds of the same
    update (the fixpoint is reached within K rounds, box i's flag final
    after round i + 1, and holds after), so the loop has no data-dependent
    control flow: the form torch.export traces (tools/export_model.py)."""
    sup_edge = _suppression_edges(boxes_xyxy, iou_threshold)
    keep = valid
    for _ in range(boxes_xyxy.shape[-2]):
        keep = valid & ~(sup_edge & keep[..., :, None]).any(dim=-2)
    return keep


def nms_mask_sequential(boxes_xyxy, scores, valid, iou_threshold: float):
    """Reference formulation: one decision per candidate in score order
    (postprocess.py:64-78). Same result as `nms_mask`."""
    sup_edge = _suppression_edges(boxes_xyxy, iou_threshold)
    keep = torch.zeros_like(valid)
    for i in range(boxes_xyxy.shape[-2]):
        sup = (keep & sup_edge[..., :, i]).any(dim=-1)
        keep[..., i] = valid[..., i] & ~sup
    return keep


def postprocess_batch(decoded, *, conf_threshold: float = 0.3,
                      nms_threshold: float = 0.6, max_detections: int = 200,
                      nms_impl: str = "fixpoint"):
    """Batched eval post-processing (postprocess.py:82-128).

    decoded: (N, A, 4+1+C) with sigmoided obj/cls. Returns
    (dets (N, K, 6) rows [cx, cy, w, h, cls, score], keep (N, K) bool) with
    K = min(max_detections, A). Candidates are ordered as lax.top_k orders
    them: descending score, ties to the lower anchor index (a stable sort).
    nms_impl: "fixpoint" (`nms_mask`, rounds until no flag changes),
    "rounds" (`nms_mask_rounds`, K rounds: the exported form) or
    "sequential"; the three keep the same boxes.
    """
    boxes = decoded[..., :4]
    obj = decoded[..., 4]
    cls_probs = decoded[..., 5:]
    K = min(max_detections, decoded.shape[1])

    with span("serve.select"):
        sel_scores = torch.where(obj > conf_threshold, obj, -1.0)
        top_scores, top_idx = torch.sort(sel_scores, dim=-1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
        valid = top_scores > conf_threshold

        top_boxes = torch.gather(boxes, 1,
                                 top_idx[..., None].expand(-1, -1, 4))
        top_cls = torch.gather(cls_probs, 1, top_idx[..., None].expand(
            -1, -1, cls_probs.shape[-1]))
    nms = {"fixpoint": nms_mask, "rounds": nms_mask_rounds,
           "sequential": nms_mask_sequential}[nms_impl]
    keep = nms(cxcywh_to_xyxy(top_boxes), top_scores, valid, nms_threshold)

    cls_max, cls_id = top_cls.max(dim=-1)
    score = top_scores * cls_max
    dets = torch.cat([top_boxes, cls_id[..., None].to(top_boxes.dtype),
                      score[..., None]], dim=-1)
    return dets, keep


def postprocess_image(decoded, **kwargs):
    """One image: decoded (A, 4+1+C) → (dets (K, 6), keep (K,))."""
    dets, keep = postprocess_batch(decoded[None], **kwargs)
    return dets[0], keep[0]


def finalize_detections(dets, keep):
    """Host side (postprocess.py:131-144): (N, K, 6) dets and (N, K) keep,
    tensors on any device or arrays, → per image the kept rows as an
    (n, 6) f32 numpy array, or one all-zero row where none is kept (the
    reference's dummy row, yolo_head.py:277-278). One host read."""
    if isinstance(dets, torch.Tensor):
        dets, keep = dets.float().cpu().numpy(), keep.cpu().numpy()
    out = []
    for d, k in zip(np.asarray(dets), np.asarray(keep)):
        rows = d[k]
        if len(rows) == 0:
            rows = np.zeros((1, 6), dtype=np.float32)
        out.append(rows)
    return out
