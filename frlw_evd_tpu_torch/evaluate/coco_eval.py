"""Timestamp-tolerant COCO detection evaluation (a copy of
frlw_evd_tpu/evaluate/coco_eval.py; reference:
evaluate/src/metrics/coco_eval.py).

GT and DT boxes are (N, 8) numpy arrays in the Prophesee column order
[t, x, y, w, h, class_id, track_id, class_confidence]. Detections are matched
to each GT timestamp within ±time_tol µs, then scored with the COCO protocol.
"""

from __future__ import annotations

import numpy as np

from .coco_map import COCOMeanAP


def evaluate_detection(gt_boxes_list, dt_boxes_list,
                       classes=("car", "pedestrian"), height=240, width=304,
                       time_tol=50000):
    """Compute the 6 COCO stats over lists of per-file box arrays.

    KPIs are only computed at timestamps with at least one GT box; files with
    no GT or no DT rows are skipped entirely (reference :32-34).
    """
    flattened_gt = []
    flattened_dt = []
    for gt_boxes, dt_boxes in zip(gt_boxes_list, dt_boxes_list):
        if gt_boxes.shape[0] == 0 or dt_boxes.shape[0] == 0:
            continue
        all_ts = np.unique(gt_boxes[:, 0])
        gt_win, dt_win = _match_times(all_ts, gt_boxes, dt_boxes, time_tol)
        flattened_gt += gt_win
        flattened_dt += dt_win
    return _coco_eval(flattened_gt, flattened_dt, num_classes=len(classes))


def _match_times(all_ts, gt_boxes, dt_boxes, time_tol):
    """Two-pointer windowing of time-sorted GT/DT arrays per GT timestamp
    (reference :47-86). DTs within [ts - tol, ts + tol] count for ts."""
    gt_size = len(gt_boxes)
    dt_size = len(dt_boxes)
    windowed_gt, windowed_dt = [], []
    low_gt, high_gt = 0, 0
    low_dt, high_dt = 0, 0
    for ts in all_ts:
        while low_gt < gt_size and gt_boxes[low_gt, 0] < ts:
            low_gt += 1
        high_gt = max(low_gt, high_gt)
        while high_gt < gt_size and gt_boxes[high_gt, 0] <= ts:
            high_gt += 1
        low = ts - time_tol
        high = ts + time_tol
        while low_dt < dt_size and dt_boxes[low_dt, 0] < low:
            low_dt += 1
        high_dt = max(low_dt, high_dt)
        while high_dt < dt_size and dt_boxes[high_dt, 0] <= high:
            high_dt += 1
        windowed_gt.append(gt_boxes[low_gt:high_gt])
        windowed_dt.append(dt_boxes[low_dt:high_dt])
    return windowed_gt, windowed_dt


def _coco_eval(gts, detections, num_classes: int):
    """Score windowed per-timestamp box lists with the COCO protocol."""
    evaluator = COCOMeanAP(num_classes)
    for gt, dt in zip(gts, detections):
        evaluator.add_image(gt, dt)
    return evaluator.summarize()
