"""Self-contained COCO bbox mean-AP implementation (numpy + native matcher;
a copy of frlw_evd_tpu/evaluate/coco_map.py on the port's utils/native).

pycocotools is not a dependency, so this module implements the standard
COCO detection evaluation protocol itself, producing the same six summary
stats the reference prints
(evaluate/src/metrics/coco_eval.py:107-113 via pycocotools):
  stats[0] AP@[.5:.95] | stats[1] AP50 | stats[2] AP75
  stats[3] AP small    | stats[4] AP medium | stats[5] AP large

Protocol (matching COCOeval 'bbox' with default params):
  * IoU thresholds 0.50:0.05:0.95, recall grid 0:0.01:1 (101 points)
  * area ranges all/[0,32²]/[32²,96²]/[96²,1e10], maxDets 100
  * greedy per-image per-category matching in descending score order with
    pycocotools tie-breaks (strict '<' skip — a later equal-IoU gt wins;
    ignored gts stably sorted after real ones; scan breaks at the first
    ignored gt once a real one is matched); gts outside the area range are
    "ignored" (match allowed, excluded from counts); unmatched detections
    outside the area range are ignored
  * precision envelope (monotone non-increasing) sampled at the recall grid,
    averaged over categories and IoU thresholds

Production path: IoUs are computed ONCE per (image, category) and the greedy
match over all 10 thresholds × 4 area ranges runs in one native C++ call
(native/kernels.cpp coco_match, pure-numpy fallback in utils/native.py) —
the per-epoch validation loop stays sub-minute even at GEN1 test-split scale
(hundreds of thousands of windows).

Inputs are plain per-image box lists in the Prophesee 8-column layout
[t, x, y, w, h, class_id, track_id, class_confidence]; no COCO-JSON detour.
"""

from __future__ import annotations

import numpy as np

from ..utils import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
_AREA_KEYS = ("all", "small", "medium", "large")
MAX_DETS = 100


def iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) [x, y, w, h] → (D, G) IoU."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    d_x1, d_y1 = dt[:, 0:1], dt[:, 1:2]
    d_x2, d_y2 = dt[:, 0:1] + dt[:, 2:3], dt[:, 1:2] + dt[:, 3:4]
    g_x1, g_y1 = gt[None, :, 0], gt[None, :, 1]
    g_x2, g_y2 = gt[None, :, 0] + gt[None, :, 2], gt[None, :, 1] + gt[None, :, 3]
    iw = np.maximum(np.minimum(d_x2, g_x2) - np.maximum(d_x1, g_x1), 0.0)
    ih = np.maximum(np.minimum(d_y2, g_y2) - np.maximum(d_y1, g_y1), 0.0)
    inter = iw * ih
    area_d = (dt[:, 2] * dt[:, 3])[:, None]
    area_g = (gt[:, 2] * gt[:, 3])[None, :]
    union = area_d + area_g - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOMeanAP:
    """Accumulates per-image GT/DT (in the Prophesee 8-column format) and
    computes the six COCO summary stats.

    Note: detection score is read from column 7 (class_confidence per
    BBOX_DTYPE); the reference's `_to_coco_format` reads column 6 of its own
    7-column detection rows — documented deviation, same value."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.gts = []   # list of (N, 8) arrays, one per image
        self.dts = []

    def add_image(self, gt_boxes: np.ndarray, dt_boxes: np.ndarray):
        self.gts.append(np.asarray(gt_boxes, dtype=np.float64))
        self.dts.append(np.asarray(dt_boxes, dtype=np.float64))

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _concat(rows_list):
        """list of (N, 8) → ((N_total, 8), img_id (N_total,) int64)."""
        lens = np.array([len(r) for r in rows_list], np.int64)
        if lens.sum() == 0:
            return np.zeros((0, 8)), np.zeros(0, np.int64), lens
        ncol = next(r.shape[1] for r in rows_list if len(r))
        cat = np.concatenate(
            [r if len(r) else np.zeros((0, ncol)) for r in rows_list])
        img = np.repeat(np.arange(len(rows_list), dtype=np.int64), lens)
        return cat, img, lens

    def _compute_precision(self):
        """precision (A, T, R, K); -1 where undefined (no gt)."""
        n_img = len(self.gts)
        A, T, R, K = (len(_AREA_KEYS), len(IOU_THRS), len(REC_THRS),
                      self.num_classes)
        rngs = np.array([AREA_RNGS[k] for k in _AREA_KEYS], np.float64)
        precision = -np.ones((A, T, R, K))

        gt_all, gt_img, _ = self._concat(self.gts)
        dt_all, dt_img, _ = self._concat(self.dts)

        for k in range(K):
            gsel = gt_all[:, 5] == k
            g_boxes = np.ascontiguousarray(gt_all[gsel, 1:5])
            g_off = np.zeros(n_img + 1, np.int64)
            np.cumsum(np.bincount(gt_img[gsel], minlength=n_img),
                      out=g_off[1:])

            dsel = dt_all[:, 5] == k
            d_boxes = dt_all[dsel, 1:5]
            d_scores = dt_all[dsel, 7]
            d_img = dt_img[dsel]
            # per-image descending-score stable sort + maxDets truncation
            order = np.lexsort((np.arange(len(d_scores)), -d_scores, d_img))
            d_boxes, d_scores, d_img = (d_boxes[order], d_scores[order],
                                        d_img[order])
            counts = np.bincount(d_img, minlength=n_img)
            off = np.zeros(n_img + 1, np.int64)
            np.cumsum(counts, out=off[1:])
            rank = np.arange(len(d_img)) - off[d_img]
            keep = rank < MAX_DETS
            d_boxes = np.ascontiguousarray(d_boxes[keep])
            d_scores = d_scores[keep]
            d_img = d_img[keep]
            d_off = np.zeros(n_img + 1, np.int64)
            np.cumsum(np.bincount(d_img, minlength=n_img), out=d_off[1:])

            codes, npig = native.coco_match(d_boxes, d_off, g_boxes, g_off,
                                            IOU_THRS, rngs)

            # global accumulate: all detections sorted by score desc (stable)
            order2 = np.argsort(-d_scores, kind="mergesort")
            nd = len(order2)
            codes = codes[:, :, order2]
            # int32 accumulate: np.cumsum over bool with dtype=float64 is
            # ~50x slower than int32 (numpy pairwise-sum path)
            tp_sum = np.cumsum(codes == 1, axis=2, dtype=np.int32)
            fp_sum = np.cumsum(codes == 0, axis=2, dtype=np.int32)

            for a in range(A):
                if npig[a] == 0:
                    continue
                if nd == 0:
                    precision[a, :, :, k] = 0.0
                    continue
                tp = tp_sum[a].astype(np.float64)
                fp = fp_sum[a].astype(np.float64)
                rc = tp / npig[a]                               # (T, nd)
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                for t in range(T):
                    inds = np.searchsorted(rc[t], REC_THRS, side="left")
                    valid = inds < nd
                    precision[a, t, :, k] = np.where(
                        valid, pr[t][np.minimum(inds, nd - 1)], 0.0)
        return precision

    def summarize(self):
        """Returns the 6-stat tuple (mAP, AP50, AP75, APs, APm, APl)."""
        precision = self._compute_precision()

        def mean_valid(p):
            valid = p[p > -1]
            return float(valid.mean()) if valid.size else -1.0

        p_all = precision[0]
        return (
            mean_valid(p_all),
            mean_valid(p_all[np.isclose(IOU_THRS, 0.5)]),
            mean_valid(p_all[np.isclose(IOU_THRS, 0.75)]),
            mean_valid(precision[1]),
            mean_valid(precision[2]),
            mean_valid(precision[3]),
        )
