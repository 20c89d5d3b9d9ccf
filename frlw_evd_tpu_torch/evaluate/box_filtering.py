"""GT/DT box filtering before mAP (a copy of
frlw_evd_tpu/evaluate/box_filtering.py; reference:
evaluate/src/io/box_filtering.py).

Boxes are (N, 8) arrays with columns [t, x, y, w, h, class_id, track_id,
class_confidence].
"""

from __future__ import annotations

import numpy as np


def filter_boxes(boxes: np.ndarray, skip_ts=int(5e5), min_box_diag=60,
                 min_box_height=20, min_box_width=20) -> np.ndarray:
    """Skip boxes before skip_ts and boxes too small (diag² and sides)."""
    ts = boxes[:, 0]
    width = boxes[:, 3]
    height = boxes[:, 4]
    diag_square = width**2 + height**2
    mask = ((ts > skip_ts)
            & (diag_square >= min_box_diag**2)
            & (width >= min_box_width)
            & (height >= min_box_height))
    return boxes[mask]


def filter_boxes_gen1(boxes):
    return filter_boxes(boxes, 5e5, 30, 10, 10)


def filter_boxes_large(boxes):
    return filter_boxes(boxes, 5e5, 60, 20, 20)


def filter_boxes_kitti(boxes):
    return filter_boxes(boxes, 0, 0, 25, 0)
