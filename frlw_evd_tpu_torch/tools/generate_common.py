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

SPLITS = ("train", "val", "test")
GEOMETRY = {
    "gen1": dict(shape=(240, 304), target_shape=(256, 320)),
    # 4x-reduced GEN1 geometry of the synthetic mini tree (data/synthetic)
    "gen1_mini": dict(shape=(60, 76), target_shape=(64, 96)),
    "gen4": dict(shape=(720, 1280), target_shape=(512, 640)),
}


def geometry(dataset: str):
    """(blob shape, rh, rw, upscale, encode shape) of `dataset`: GEN1
    encodes at the sensor's size and resizes the blob up (upscale), gen4
    scales the coordinates by (rh, rw) and encodes at the blob's size."""
    geo = GEOMETRY[dataset]
    shape, target_shape = geo["shape"], geo["target_shape"]
    upscale = target_shape[0] >= shape[0]
    return (target_shape, target_shape[0] / shape[0],
            target_shape[1] / shape[1], upscale,
            shape if upscale else target_shape)


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


class EncodeTimer:
    """Average encode-time counter, printed on the test split
    (reference generate_eventvolume.py:151-153,172-175)."""

    def __init__(self, labels):
        self.total = {label: 0.0 for label in labels}
        self.count = {label: 0 for label in labels}

    def add(self, label, dt):
        self.total[label] += dt
        self.count[label] += 1

    def report(self):
        print("Average Representation time: ")
        for label in self.total:
            if self.count[label]:
                print(label, self.total[label] / self.count[label])


def new_stats() -> dict:
    """A generator's counts: the blobs it wrote and their encode and
    read-back seconds on the host clock, all splits and the test split."""
    return {"blobs": 0, "encode_s": 0.0, "test_blobs": 0,
            "test_encode_s": 0.0}


def count_blob(stats: dict, mode: str, seconds: float) -> None:
    stats["blobs"] += 1
    stats["encode_s"] += seconds
    if mode == "test":
        stats["test_blobs"] += 1
        stats["test_encode_s"] += seconds


def parse_args(argv=None):
    """The generators' flags: JAX's, plus -device (default cuda)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", type=str, required=True)
    parser.add_argument("-label_dir", type=str, required=True)
    parser.add_argument("-target_dir", type=str, required=True)
    parser.add_argument("-dataset", type=str, default="gen1",
                        choices=sorted(GEOMETRY))
    parser.add_argument("-device", type=str, default="cuda")
    return parser.parse_args(argv)
