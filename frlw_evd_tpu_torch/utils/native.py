"""ctypes bindings for the host C++ helpers of native/kernels.cpp (the
port's own loader; counterpart of frlw_evd_tpu/utils/native.py).

The library is built on first use with g++ and native/Makefile's flags
into build/native/libfrlw_kernels.so (rebuilt when kernels.cpp is newer),
never into native/, and the JAX package's library is never loaded. These
are host helpers (box IoU, the COCO matcher, the sequential TAF queue
oracle), not device kernels: every entry point has the JAX module's numpy
fallback, taken when no compiler or library is at hand; `has_native()`
says which form runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "kernels.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libfrlw_kernels.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")  # native/Makefile

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    """Compile SOURCE into LIB_PATH when it is missing or older than the
    source; a temporary file moved over the target, so a concurrent build
    never loads a half-written library."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                    str(SOURCE)], check=True, capture_output=True, timeout=120)
    os.replace(tmp, LIB_PATH)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.compute_area.argtypes = [dp, i64, dp]
        lib.compute_overlap.argtypes = [dp, i64, dp, i64, dp]
        lib.event_queue_tensor.argtypes = [dp, i64, i64, i64, i64, i64, i64,
                                           fp]
        lib.coco_match.argtypes = [dp, ip, dp, ip, i64, dp, i64, dp, i64,
                                   i8p, ip]
    except (OSError, AttributeError, subprocess.SubprocessError):
        # no compiler, a failed build or a missing symbol: the numpy forms
        return None
    _lib = lib
    return _lib


def has_native() -> bool:
    """True when the C++ library runs, False when the numpy fallbacks do."""
    return _load() is not None


def compute_area(boxes: np.ndarray) -> np.ndarray:
    boxes = np.ascontiguousarray(boxes, np.float64)
    lib = _load()
    if lib is None:
        return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    out = np.zeros(len(boxes), np.float64)
    lib.compute_area(boxes, len(boxes), out)
    return out


def compute_overlap_py(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """compute_overlap's numpy form."""
    tl = np.maximum(boxes[:, None, :2], query[None, :, :2])
    br = np.minimum(boxes[:, None, 2:], query[None, :, 2:])
    inter = np.prod(np.maximum(br - tl, 0.0), -1)
    pos = np.all(br - tl > 0, -1)
    area_b = np.prod(boxes[:, 2:] - boxes[:, :2], -1)
    area_q = np.prod(query[:, 2:] - query[:, :2], -1)
    ua = area_b[:, None] + area_q[None, :] - inter
    return np.where(pos, inter / np.maximum(ua, 1e-300), 0.0)


def compute_overlap(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) xyxy → (N, K) IoU (compute_overlap.pyx:25 semantics)."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    query = np.ascontiguousarray(query, np.float64)
    lib = _load()
    if lib is None:
        return compute_overlap_py(boxes, query)
    out = np.zeros((len(boxes), len(query)), np.float64)
    lib.compute_overlap(boxes, len(boxes), query, len(query), out)
    return out


def coco_match(dt_boxes, dt_off, gt_boxes, gt_off, iou_thrs, area_rngs):
    """Greedy COCO matching for one category over all images at once.

    dt_boxes (D, 4) xywh pre-sorted per image by descending score and
    truncated to maxDets; dt_off/gt_off (n_img+1) int64 row offsets.
    Returns (codes (A, T, D) int8 [1 tp / 0 fp / 2 ignored],
             npig (A,) int64 non-ignored gt counts).
    Falls back to `coco_match_py` without the native lib.
    """
    dt_boxes = np.ascontiguousarray(dt_boxes, np.float64)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float64)
    dt_off = np.ascontiguousarray(dt_off, np.int64)
    gt_off = np.ascontiguousarray(gt_off, np.int64)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    area_rngs = np.ascontiguousarray(area_rngs, np.float64)
    lib = _load()
    if lib is None:
        return coco_match_py(dt_boxes, dt_off, gt_boxes, gt_off, iou_thrs,
                             area_rngs)
    codes = np.zeros((len(area_rngs), len(iou_thrs), len(dt_boxes)), np.int8)
    npig = np.zeros(len(area_rngs), np.int64)
    lib.coco_match(dt_boxes, dt_off, gt_boxes, gt_off, len(dt_off) - 1,
                   iou_thrs, len(iou_thrs), area_rngs, len(area_rngs), codes,
                   npig)
    return codes, npig


def coco_match_py(dt_boxes, dt_off, gt_boxes, gt_off, iou_thrs, area_rngs):
    """coco_match's numpy form, with identical tie-break semantics
    (pycocotools evaluateImg: strict '<' skip, later equal IoU wins, break
    at the first ignored gt after a real match)."""
    codes = np.zeros((len(area_rngs), len(iou_thrs), len(dt_boxes)), np.int8)
    npig = np.zeros(len(area_rngs), np.int64)
    for img in range(len(dt_off) - 1):
        d0, d1 = dt_off[img], dt_off[img + 1]
        g0, g1 = gt_off[img], gt_off[img + 1]
        dts = dt_boxes[d0:d1]
        gts = gt_boxes[g0:g1]
        D, G = len(dts), len(gts)
        if D == 0 and G == 0:
            continue
        gt_area = gts[:, 2] * gts[:, 3]
        dt_area = dts[:, 2] * dts[:, 3]
        if D and G:
            x1 = np.maximum(dts[:, None, 0], gts[None, :, 0])
            y1 = np.maximum(dts[:, None, 1], gts[None, :, 1])
            x2 = np.minimum(dts[:, None, 0] + dts[:, None, 2],
                            gts[None, :, 0] + gts[None, :, 2])
            y2 = np.minimum(dts[:, None, 1] + dts[:, None, 3],
                            gts[None, :, 1] + gts[None, :, 3])
            inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
            union = dt_area[:, None] + gt_area[None, :] - inter
            iou = np.where((x2 > x1) & (y2 > y1) & (union > 0),
                           inter / np.maximum(union, 1e-300), 0.0)
        else:
            iou = np.zeros((D, G))
        for a, (lo, hi) in enumerate(area_rngs):
            ig = (gt_area < lo) | (gt_area > hi)
            order = np.concatenate([np.flatnonzero(~ig),
                                    np.flatnonzero(ig)]).astype(np.int64)
            n_real = int((~ig).sum())
            npig[a] += n_real
            for t, thr in enumerate(iou_thrs):
                gtm = np.full(G, -1, np.int64)
                for d in range(D):
                    best = min(thr, 1 - 1e-10)
                    m = -1
                    for oi in range(G):
                        if gtm[oi] >= 0:
                            continue
                        if m > -1 and oi >= n_real and m < n_real:
                            break
                        v = iou[d, order[oi]]
                        if v < best:
                            continue
                        best = v
                        m = oi
                    if m == -1:
                        codes[a, t, d0 + d] = 2 if (dt_area[d] < lo or
                                                    dt_area[d] > hi) else 0
                    else:
                        gtm[m] = d
                        codes[a, t, d0 + d] = 2 if m >= n_real else 1
    return codes, npig


def event_queue_tensor_py(events: np.ndarray, batch: int, height: int,
                          width: int, K: int, n_bins: int,
                          init_value: float = -6000.0) -> np.ndarray:
    """event_queue_tensor's numpy form, bin by bin through the oracle."""
    from ..encode import oracle

    events = np.ascontiguousarray(events, np.float64)
    out = np.full((batch, height, width, 2, K), init_value, np.float32)
    for b in range(batch):
        ev_b = events[events[:, 0] == b]
        state = out[b].copy()
        for i in range(n_bins):
            ev = ev_b[ev_b[:, 5] == i][:, [1, 2, 3, 4]]
            state = oracle.taf_bin(ev.astype(np.float32), (height, width),
                                   state)
        out[b] = state
    return out


def event_queue_tensor(events: np.ndarray, batch: int, height: int,
                       width: int, K: int, n_bins: int,
                       init_value: float = -6000.0) -> np.ndarray:
    """Sequential TAF queue oracle: events (n, 6) [b, x, y, t, p, z] sorted by
    z → (batch, H, W, 2, K) float32 queue tensor."""
    lib = _load()
    if lib is None:
        return event_queue_tensor_py(events, batch, height, width, K, n_bins,
                                     init_value)
    events = np.ascontiguousarray(events, np.float64)
    out = np.full((batch, height, width, 2, K), init_value, np.float32)
    lib.event_queue_tensor(events, len(events), batch, height, width, K,
                           n_bins, out)
    return out
