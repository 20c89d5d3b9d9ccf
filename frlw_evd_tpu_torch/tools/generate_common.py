"""Shared scaffolding for the offline representation generators (counterpart
of tools/generate_common.py).

Each generator walks {train,val,test}, and for every unique annotation
timestamp seeks an event window, encodes it on the device and writes
`<stream>_<timestamp>.npy` uint8 blobs in the reference's layout
(reference generate_*.py).
"""

from __future__ import annotations

import os

import numpy as np

from ..events.npy_codec import load_bboxes

GEOMETRY = {
    "gen1": dict(shape=(240, 304), target_shape=(256, 320)),
    # 4x-reduced GEN1 geometry of the synthetic mini tree (data/synthetic)
    "gen1_mini": dict(shape=(60, 76), target_shape=(64, 96)),
    "gen4": dict(shape=(720, 1280), target_shape=(512, 640)),
}


def iter_streams(raw_dir: str, label_dir: str, mode: str):
    """Yield (stream_name, event_path, bbox_path) for one split."""
    file_dir = os.path.join(raw_dir, mode)
    label_root = os.path.join(label_dir, mode)
    if not os.path.isdir(file_dir):
        return
    files = sorted(f[:-7] for f in os.listdir(file_dir) if f.endswith("dat"))
    for name in files:
        yield (name, os.path.join(file_dir, name + "_td.dat"),
               os.path.join(label_root, name + "_bbox.npy"))


def unique_annotation_times(bbox_path: str) -> np.ndarray:
    boxes = load_bboxes(bbox_path)
    return np.unique(boxes["t"])


def events_to_xytp(events) -> np.ndarray:
    out = np.empty((len(events), 4), dtype=np.float64)
    out[:, 0] = events["x"]
    out[:, 1] = events["y"]
    out[:, 2] = events["ts"] if "ts" in events.dtype.names else events["t"]
    out[:, 3] = events["p"]
    return out
