"""Bounding-box dtype and helpers for Prophesee annotation files (a copy of
frlw_evd_tpu/events/box_loading.py).

Reference: evaluate/src/io/box_loading.py:14 (BBOX_DTYPE), :17 (reformat).
"""

from __future__ import annotations

import numpy as np

BBOX_DTYPE = np.dtype(
    {
        "names": ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"],
        "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
        "offsets": [0, 8, 12, 16, 20, 24, 28, 32],
        "itemsize": 40,
    }
)


def reformat_boxes(boxes: np.ndarray) -> np.ndarray:
    """Normalise legacy field names (ts → t, confidence → class_confidence)."""
    if "t" in boxes.dtype.names and "class_confidence" in boxes.dtype.names:
        return boxes
    new = np.zeros((len(boxes),), dtype=BBOX_DTYPE)
    for name in boxes.dtype.names:
        if name == "ts":
            new["t"] = boxes[name]
        elif name == "confidence":
            new["class_confidence"] = boxes[name]
        else:
            new[name] = boxes[name]
    return new


def boxes_to_array(boxes: np.ndarray) -> np.ndarray:
    """Structured bbox records → float64 array with the canonical column order
    [t, x, y, w, h, class_id, track_id, class_confidence] used throughout the
    evaluation pipeline."""
    cols = ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"]
    return np.stack([boxes[c].astype(np.float64) for c in cols], axis=-1)


def array_to_boxes(arr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`boxes_to_array`."""
    out = np.zeros((len(arr),), dtype=BBOX_DTYPE)
    cols = ["t", "x", "y", "w", "h", "class_id", "track_id", "class_confidence"]
    for i, c in enumerate(cols):
        out[c] = arr[:, i]
    return out
