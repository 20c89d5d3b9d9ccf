"""Datasets over precomputed representation blobs (a copy of
frlw_evd_tpu/data/dataset.py; reference: data/dataset.py). The same
`random.Random(seed)` draws give the same samples as the JAX package.

Index = every (stream, annotation-timestamp) pair whose encoded blob exists.
Samples return NHWC float volumes plus padded labels:
  train rows: [class, cx, cy, w, h]
  eval rows:  [cx, cy, w, h, class, t, track_id, class_confidence]
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np

from ..events.npy_codec import load_bboxes
from .augment import augment_sample, pad_labels, transform_volume, xyxy2cxcywh

GEN1_CLASSES = ["Car", "Pedestrian"]
GEN4_CLASSES = ["pedestrian", "two wheeler", "car", "truck", "bus",
                "traffic sign", "traffic light"]
KITTI_CLASSES = ["Car", "Pedestrian"]

MAX_LABELS = 80


def dataset_geometry(dataset: str):
    if dataset == "gen1":
        return (240, 304), GEN1_CLASSES
    if dataset == "kitti":
        return (375, 1242), KITTI_CLASSES
    return (720, 1280), GEN4_CLASSES


class PropheseeDataset:
    """Generic representation dataset (propheseeDataset, dataset.py:24).

    Unlike the reference's `load_data` (which collapses the volume to a
    2-channel mean — the leftover defect at dataset.py:246-247 that breaks
    channel counts for multi-bin representations), this loads the full
    2·bins channels. Set ``collapse_channels=True`` to replicate the defect.
    """

    def __init__(self, bbox_dir: str, data_dir: str, dataset: str = "gen1",
                 input_img_size=(256, 320), img_size=(256, 320),
                 time_channels: int = 5, infer_time: int = 10000,
                 mode: str = "train", augment: bool = True,
                 clipping: bool = False, collapse_channels: bool = False,
                 seed: int = 0, sensor_hw=None):
        self.mode = mode
        self.augment = augment
        self.clipping = clipping
        self.collapse_channels = collapse_channels
        self.dataset = dataset
        self.input_img_size = tuple(input_img_size)
        self.img_size = tuple(img_size)
        self.time_channels = time_channels
        self.infer_time = infer_time
        self.rng = random.Random(seed)

        (self.height, self.width), self.object_classes = dataset_geometry(dataset)
        if sensor_hw is not None:
            # non-standard sensor geometry (e.g. the mini test fixtures):
            # labels are rescaled sensor→input with THIS geometry, so the
            # hard-coded dataset default must not leak in
            self.height, self.width = sensor_hw

        self.root = os.path.join(bbox_dir, mode)
        self.data_dir = data_dir
        files = [f[:-9] for f in sorted(os.listdir(self.root))
                 if f.endswith("npy")]
        self.files = files

        self.file_name: List[str] = []
        self.sequence_end_t: List[int] = []
        self._build_index()

    # -- index -------------------------------------------------------------
    def _blob_dir(self) -> str:
        return os.path.join(self.data_dir, self.mode)

    def _blob_path(self, stream: str, ts: int) -> str:
        return os.path.join(self._blob_dir(), f"{stream}_{ts}.npy")

    def _build_index(self):
        for stream in self.files:
            boxes = load_bboxes(os.path.join(self.root, stream + "_bbox.npy"))
            unique_ts = np.unique(boxes["t"])
            for ts in unique_ts:
                if os.path.exists(self._blob_path(stream, int(ts))):
                    self.sequence_end_t.append(int(ts))
                    self.file_name.append(stream)

    def __len__(self):
        return len(self.file_name)

    # -- loading -----------------------------------------------------------
    def load_volume(self, idx: int) -> np.ndarray:
        """Blob → (C, H, W) float32."""
        path = self._blob_path(self.file_name[idx], self.sequence_end_t[idx])
        volume = np.fromfile(path, dtype=np.uint8).reshape(
            2 * self.time_channels, self.img_size[0], self.img_size[1]
        ).astype(np.float32)
        if self.collapse_channels:
            volume = np.stack([volume.mean(0), volume.mean(0)])
        return volume

    def load_boxes(self, idx: int) -> np.ndarray:
        """Annotation rows at this sample's timestamp, sensor coords,
        columns [x, y, w, h, class_id, t, track_id, class_confidence]."""
        boxes = load_bboxes(os.path.join(self.root,
                                         self.file_name[idx] + "_bbox.npy"))
        boxes = boxes[boxes["t"] == self.sequence_end_t[idx]]
        return np.stack([
            boxes["x"], boxes["y"], boxes["w"], boxes["h"],
            boxes["class_id"].astype(np.float64),
            boxes["t"].astype(np.float64),
            boxes["track_id"].astype(np.float64),
            boxes["class_confidence"].astype(np.float64),
        ], axis=-1)

    def __getitem__(self, idx: int):
        np_bbox_raw = self.load_boxes(idx)
        unique_ts = np.unique(np_bbox_raw[:, 5])

        np_bbox, sr, flip, cx, cy = augment_sample(
            np_bbox_raw, unique_ts, self.input_img_size,
            (self.height, self.width), self.dataset, self.augment,
            self.clipping, self.mode, self.rng)

        boxes = xyxy2cxcywh(np_bbox[:, :4].copy())
        labels = np_bbox[:, 4:].copy()
        if self.mode == "train":
            targets = np.hstack([labels[:, 0:1], boxes])
        else:
            targets = np.hstack([boxes, labels])
        padded = pad_labels(targets, MAX_LABELS)

        volume = self.load_volume(idx)
        volume = transform_volume(volume, self.input_img_size, sr, flip, cx, cy)
        img = volume.transpose(1, 2, 0).astype(np.float32)  # HWC

        return img, padded, self.file_name[idx], self.sequence_end_t[idx]


class PropheseeTafDataset(PropheseeDataset):
    """TAF two-directory layout (propheseeTafDataset, dataset.py:255-307):
    for K > 4 concatenate bins{K/2} (newest bins) with bins{K}."""

    def __init__(self, bbox_dir, data_dir, dataset="gen1",
                 input_img_size=(256, 320), img_size=(256, 320),
                 infer_time=10000, event_volume_bins=8, mode="train",
                 augment=True, clipping=False, seed: int = 0,
                 sensor_hw=None):
        super().__init__(bbox_dir, data_dir, dataset, input_img_size, img_size,
                         event_volume_bins, infer_time, mode, augment,
                         clipping, seed=seed, sensor_hw=sensor_hw)

    def _blob_path(self, stream, ts):
        # the index always checks the bins8 directory (dataset.py:266)
        return os.path.join(self._blob_dir(), "bins8", f"{stream}_{ts}.npy")

    def load_volume(self, idx):
        root = self._blob_dir()
        stream, ts = self.file_name[idx], self.sequence_end_t[idx]
        K = self.time_channels
        h, w = self.img_size
        if K > 4:
            p1 = os.path.join(root, f"bins{K // 2}", f"{stream}_{ts}.npy")
            v1 = np.fromfile(p1, dtype=np.uint8).reshape(K, h, w)
            p2 = os.path.join(root, f"bins{K}", f"{stream}_{ts}.npy")
            v2 = np.fromfile(p2, dtype=np.uint8).reshape(K, h, w)
            volume = np.concatenate([v1, v2], 0).astype(np.float32)
        else:
            p = os.path.join(root, f"bins{K}", f"{stream}_{ts}.npy")
            volume = np.fromfile(p, dtype=np.uint8).reshape(
                K * 2, h, w).astype(np.float32)
        return volume
