"""Shared helpers of the motion-level analysis chain (counterpart of
tools/motion_level.py; reference generate_opticalflow.py,
motion_level_statistics_*.py).

The chain: optical flow between two event time surfaces per annotation →
per-box mean flow magnitude ("density") for GT and detections → mAP
stratified into 5 motion quintiles. The surfaces are made in torch on the
device given, the flow is tools/farneback.py's on that device; the box
statistics are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .farneback import farneback_flow

PERCENTILES = {
    # hard-coded motion-density quintile bounds (motion_level_evaluation.py:29-35)
    "gen1": [0.0, 0.09472751189131885, 0.2538587115258659,
             0.6169536673563197, 1.703355726917305, 1000],
    "gen4": [0.0, 0.061864120261698595, 0.47486729209948575,
             1.4415784200310098, 4.20493449274388, 1000],
}
PERCENTILES["gen1_mini"] = PERCENTILES["gen1"]


def overlap_dedup_nms(dets: np.ndarray) -> list:
    """The statistics scripts' keep-pop NMS variant (thresh 0.1): a box is
    kept only when it overlaps NOTHING else above threshold — clusters of
    overlapping boxes are dropped entirely (motion_level_statistics_gt.py:12-43
    keep-pop trick). dets columns [t, x1, y1, x2, y2, ...]."""
    x1, y1 = dets[:, 1], dets[:, 2]
    x2, y2 = dets[:, 3], dets[:, 4]
    areas = (x2 - x1) * (y2 - y1)
    order = np.arange(len(dets))
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(1e-28, xx2 - xx1)
        h = np.maximum(1e-28, yy2 - yy1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        inds = np.where(ovr <= 0.1)[0]
        if len(inds) != len(ovr):
            keep.pop()
        order = order[inds + 1]
    return keep


def clip_box_xywh(row, shape):
    """In-place clip of a [t, x, y, w, h, ...] row to the sensor; returns the
    clipped (x1, y1, x2, y2)."""
    h_s, w_s = shape
    x1, y1 = row[1], row[2]
    x2, y2 = row[3] + row[1], row[4] + row[2]
    x1 = min(max(x1, 0), w_s - 1)
    x2 = min(max(x2, 0), w_s - 1)
    y1 = min(max(y1, 0), h_s - 1)
    y2 = min(max(y2, 0), h_s - 1)
    row[1], row[2], row[3], row[4] = x1, y1, x2 - x1, y2 - y1
    return x1, y1, x2, y2


def box_flow_density(flow: np.ndarray, x1, y1, x2, y2) -> float:
    """Mean flow magnitude inside the box (statistics scripts)."""
    mag = np.sqrt(flow[int(y1):int(y2), int(x1):int(x2), 0] ** 2
                  + flow[int(y1):int(y2), int(x1):int(x2), 1] ** 2)
    return float(np.sum(mag) / (int(y2 - y1) * int(x2 - x1) + 1e-8))


def generate_timesurface(events, shape, device="cuda"):
    """Two normalised last-event-time surfaces 50 ms apart
    (generate_opticalflow.py:73-92), f64 (H, W) tensors on `device`.
    events: (N, 4) [x, y, t, p], numpy or a tensor, in time order: a
    pixel's last event is its latest, so each surface is a scatter max."""
    dev = torch.device(device)
    ev = torch.as_tensor(events, dtype=torch.float64).to(dev)
    H, W = shape
    volume1 = torch.zeros(H * W, dtype=torch.float64, device=dev)
    volume2 = torch.zeros(H * W, dtype=torch.float64, device=dev)
    if len(ev) == 0:
        return volume1.view(H, W), volume2.view(H, W)
    t = ev[:, 2]
    end_stamp, start_stamp = t.max(), t.min()
    idx = ev[:, 1].long() * W + ev[:, 0].long()
    early = t < end_stamp - 50000
    volume1.scatter_reduce_(0, idx[early], t[early], "amax")
    volume2.scatter_reduce_(0, idx, t, "amax")
    denom = end_stamp - 50000 - start_stamp
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    volume1 = torch.maximum((volume1 - start_stamp) / denom * 255, zero)
    volume2 = torch.maximum((volume2 - start_stamp - 50000) / denom * 255,
                            zero)
    return volume1.view(H, W), volume2.view(H, W)


def compute_flow(prev, curr, device="cuda") -> np.ndarray:
    """Dense Farneback flow (H, W, 2) f32 from prev to curr (uint8
    surfaces), computed on `device` (tools/farneback.py: OpenCV's
    Farneback with compute_flow's parameters; TV-L1, which the JAX tool
    takes where cv2.optflow exists, is not ported), read to the host."""
    return farneback_flow(prev, curr, device).cpu().numpy()
