"""Label-preserving zoom/flip augmentation (a copy of
frlw_evd_tpu/data/augment.py on the port's encode/oracle; reference:
data/dataset.py:139-234).

Host-side numpy; the volume transform is nearest-resize + crop + flip applied
to the CHW float volume, exactly as the reference applies torch interpolate +
slicing. Retries up to 100 draws until every annotated timestamp keeps at
least one box, then falls back to no augmentation.
"""

from __future__ import annotations

import random

import numpy as np

from ..encode.oracle import nearest_resize


def xyxy2cxcywh(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = (boxes[:, 0] + boxes[:, 2]) / 2
    out[:, 1] = (boxes[:, 1] + boxes[:, 3]) / 2
    out[:, 2] = boxes[:, 2] - boxes[:, 0]
    out[:, 3] = boxes[:, 3] - boxes[:, 1]
    return out


def _scale_boxes(np_bbox, rw, rh, cx, cy):
    """[x,y,w,h,cls,t,track,conf] rows → xyxy-scaled copy."""
    return np.stack([
        np_bbox[:, 0] * rw + cx,
        np_bbox[:, 1] * rh + cy,
        (np_bbox[:, 0] + np_bbox[:, 2]) * rw + cx,
        (np_bbox[:, 1] + np_bbox[:, 3]) * rh + cy,
        np_bbox[:, 4], np_bbox[:, 5], np_bbox[:, 6], np_bbox[:, 7],
    ], axis=-1)


def draw_augmentation(input_hw, augment: bool, rng: random.Random):
    """Draw (scale_ratio, flip, cx, cy) exactly like the reference loop body."""
    sr = rng.uniform(1.0, 1.5) if (augment and rng.random() < 0.5) else 1.0
    flip = bool(augment and rng.random() < 0.5)
    h, w = input_hw
    if sr > 1.0:
        cx = int(rng.uniform(int(w - sr * w), 0))
        cy = int(rng.uniform(int(h - sr * h), 0))
    else:
        cx, cy = 0, 0
    return sr, flip, cx, cy


def filter_boxes_for_aug(np_bbox, input_hw, dataset: str, augment: bool):
    """Drop boxes pushed (mostly) out of frame (dataset.py:169-182)."""
    h, w = input_hw
    if dataset == "gen4":
        if augment:
            np_bbox = np_bbox.copy()
            np.clip(np_bbox[:, 0], 0, w, out=np_bbox[:, 0])
            np.clip(np_bbox[:, 1], 0, h, out=np_bbox[:, 1])
            np.clip(np_bbox[:, 2], 0, w, out=np_bbox[:, 2])
            np.clip(np_bbox[:, 3], 0, h, out=np_bbox[:, 3])
            np_bbox = np_bbox[(np_bbox[:, 2] - np_bbox[:, 0] > 5)
                              & (np_bbox[:, 3] - np_bbox[:, 1] > 5)]
    else:
        if augment:
            keep = ((np_bbox[:, 2] > 10) & (np_bbox[:, 3] > 10)
                    & (np_bbox[:, 0] < w - 10) & (np_bbox[:, 1] < h - 10))
            np_bbox = np_bbox[keep]
    return np_bbox


def augment_sample(np_bbox_raw, unique_ts, input_hw, sensor_hw, dataset: str,
                   augment: bool, clipping: bool, mode: str,
                   rng: random.Random):
    """Draw augmentation params + transform boxes with the retry loop.

    Args:
      np_bbox_raw: (B, 8) rows [x, y, w, h, class_id, t, track_id, conf]
        in SENSOR coordinates.
      unique_ts: annotated timestamps that must each keep >= 1 box.
    Returns (boxes_xyxy_and_meta (B', 8), sr, flip, cx, cy).
    """
    h_in, w_in = input_hw
    rh_ori = input_hw[0] / sensor_hw[0]
    rw_ori = input_hw[1] / sensor_hw[1]

    count = 0
    while True:
        sr, flip, cx, cy = draw_augmentation(input_hw, augment, rng)
        rh, rw = sr * rh_ori, sr * rw_ori
        np_bbox = _scale_boxes(np_bbox_raw, rw, rh, cx, cy)
        np_bbox = filter_boxes_for_aug(np_bbox, input_hw, dataset, augment)
        ok = all((np_bbox[np_bbox[:, 5] == t].shape[0] > 0) for t in unique_ts)
        count += 1
        if ok:
            break
        if count > 100:
            np_bbox = _scale_boxes(np_bbox_raw, rw_ori, rh_ori, 0, 0)
            sr, flip, cx, cy = 1.0, False, 0, 0
            break

    if (mode == "train" and clipping) or (dataset == "gen4"):
        np.clip(np_bbox[:, 0], 0, w_in, out=np_bbox[:, 0])
        np.clip(np_bbox[:, 1], 0, h_in, out=np_bbox[:, 1])
        np.clip(np_bbox[:, 2], 0, w_in, out=np_bbox[:, 2])
        np.clip(np_bbox[:, 3], 0, h_in, out=np_bbox[:, 3])

    if flip:
        # x1' = W - x2 - 1, x2' = W - x1 - 1 (dataset.py:205)
        x1 = np_bbox[:, 0].copy()
        np_bbox[:, 0] = w_in - np_bbox[:, 2] - 1
        np_bbox[:, 2] = w_in - x1 - 1
    return np_bbox, sr, flip, cx, cy


def transform_volume(volume_chw: np.ndarray, input_hw, sr: float, flip: bool,
                     cx: int, cy: int) -> np.ndarray:
    """Apply the drawn augmentation to a CHW float volume
    (dataset.py:221-234): nearest resize to sr·input, /255, crop, flip."""
    h_in, w_in = input_hw
    vol = nearest_resize(volume_chw, (int(h_in * sr), int(w_in * sr)))
    vol = vol / 255.0
    vol = vol[:, -cy:h_in - cy, -cx:w_in - cx]
    if flip:
        vol = vol[:, :, ::-1]
    return np.ascontiguousarray(vol)


def pad_labels(targets: np.ndarray, max_labels: int = 80) -> np.ndarray:
    padded = np.zeros((max_labels, targets.shape[1]), dtype=np.float64)
    n = min(len(targets), max_labels)
    padded[:n] = targets[:n]
    return padded
