"""Detection evaluator: accumulation, rescale, latency counters, recorder (a
copy of frlw_evd_tpu/evaluate/evaluator.py; reference: evaluate/evaluator.py).
The caller times each batch: the port's Trainer.eval_epoch reads the clock
after torch.cuda.synchronize() on the card.

Quirks preserved for bit-compatibility:
  * GT rows are kept only when track_id > 0 (reference :45) — padded label
    rows are all-zero, and the reference uses the track-id column as the
    validity filter;
  * when a GT window has detections filtered to zero, a dummy zero-box row is
    inserted so the window still counts (reference :99);
  * the first batch's timing is discarded (warm-up, reference :35-37);
  * time tolerance = infer_time/2 - 1 µs (reference :31).

Deliberate deviation: detection rows here follow the canonical BBOX_DTYPE
column order [t, x, y, w, h, class_id, track_id, class_confidence] with the
score at column 7. The reference's transform_dt (:56-63) emits
[t, x1, y1, w, h, cls, score, 0] — score at column 6, colliding with
BBOX_DTYPE's track_id — which makes its own psee_evaluator read track ids as
scores for on-disk dt files. Keeping score at 7 everywhere makes the folder
evaluator, the recorder dumps and the motion-level chain mutually consistent.
"""

from __future__ import annotations

import os

import numpy as np

from .box_filtering import filter_boxes_gen1, filter_boxes_kitti, filter_boxes_large
from .coco_eval import evaluate_detection


class Evaluator:
    def __init__(self, classes, batchsize, infer_time, ori_width, ori_height,
                 input_width, input_height, dataset="gen1", recorder=None):
        self.dt_to_eval = []
        self.gt_to_eval = []
        self.rw = ori_width / input_width
        self.rh = ori_height / input_height
        self.ori_width = ori_width
        self.ori_height = ori_height
        self.batchsize = batchsize
        self.infer_time = 0.0
        self.represent_time = 0.0
        self.infer_count = 0
        self.first_batch = True
        self.classes = classes
        if dataset == "gen1":
            self.filter_boxes = filter_boxes_gen1
        elif dataset == "kitti":
            self.filter_boxes = filter_boxes_kitti
        else:
            self.filter_boxes = filter_boxes_large
        self.tol = int(infer_time / 2 - 1)
        self.recorder = recorder

    def cal_time(self, infer_time, represent_time):
        if self.first_batch:
            self.first_batch = False
        else:
            self.infer_time += infer_time
            self.represent_time += represent_time
            self.infer_count += 1

    def transform_gt(self, bounding_box: np.ndarray) -> np.ndarray:
        """Eval labels (cx,cy,w,h,cls,t,track,conf) → Prophesee rows, rescaled
        back to sensor resolution."""
        gt = np.asarray(bounding_box)
        gt = gt[gt[:, 6] > 0]
        return np.stack([
            gt[:, 5],
            (gt[:, 0] - gt[:, 2] / 2) * self.rw,
            (gt[:, 1] - gt[:, 3] / 2) * self.rh,
            gt[:, 2] * self.rw,
            gt[:, 3] * self.rh,
            gt[:, 4],
            gt[:, 6],
            gt[:, 7],
        ], axis=-1) if len(gt) else np.zeros((0, 8))

    def transform_dt(self, detected_bbox: np.ndarray, ts) -> np.ndarray:
        """Detections (cx,cy,w,h,cls,score) → Prophesee rows at timestamp ts."""
        dt = np.asarray(detected_bbox, dtype=np.float64)
        out = np.zeros((len(dt), 8))
        out[:, 0] = ts
        out[:, 1] = (dt[:, 0] - dt[:, 2] / 2) * self.rw
        out[:, 2] = (dt[:, 1] - dt[:, 3] / 2) * self.rh
        out[:, 3] = dt[:, 2] * self.rw
        out[:, 4] = dt[:, 3] * self.rh
        out[:, 5] = dt[:, 4]
        out[:, 6] = 0.0
        out[:, 7] = dt[:, 5]
        return out

    def add_result(self, outputs, bins_time_stamps, bounding_box, filenames,
                   infer_time, represent_time):
        """outputs: list of per-image (n, 6) detections [cx,cy,w,h,cls,score]."""
        self.cal_time(infer_time, represent_time)
        for i in range(len(outputs)):
            gt_trans = self.transform_gt(bounding_box[i])
            if len(gt_trans) == 0:
                continue
            self.gt_to_eval.append(gt_trans)
            dt_trans = self.transform_dt(outputs[i], bins_time_stamps[i])
            self.dt_to_eval.append(dt_trans)
            if self.recorder is not None:
                self.recorder.record(dt_trans, filenames[i])

    def evaluate(self):
        gt_boxes_list = map(self.filter_boxes, self.gt_to_eval)
        result_boxes_list = map(self.filter_boxes, self.dt_to_eval)
        gt_keep, dt_keep = [], []
        for g, d in zip(gt_boxes_list, result_boxes_list):
            if len(g) > 0:
                gt_keep.append(g)
                if len(d) == 0:
                    dt_keep.append(np.array([[g[0, 0], 0, 0, 0, 0, 0, 0, 0]]))
                else:
                    dt_keep.append(d)

        eval_results = evaluate_detection(
            gt_keep, dt_keep, time_tol=self.tol, classes=self.classes,
            height=self.ori_height, width=self.ori_width)

        if self.infer_count > 0:
            a_infer = 1000 * self.infer_time / self.infer_count
            print(f"Average infer time: {a_infer:.2f} ms. ")
            if self.represent_time > 0:
                a_rep = 1000 * self.represent_time / self.infer_count
                print(f"Average representation time: {a_rep:.2f} ms. ")
        if self.recorder is not None:
            self.recorder.save()
        print("Current score: ", eval_results[0])
        return eval_results


class Recorder:
    """Dumps all detections to summarise.npz for motion-level analysis
    (reference evaluator.py:117-133)."""

    def __init__(self, save_path):
        self.data_names = []
        self.dt = []
        self.save_path = save_path

    def record(self, dt_trans, file_name):
        for row in dt_trans:
            self.data_names.append(file_name)
            self.dt.append(row)

    def save(self):
        path = os.path.join(self.save_path, "summarise.npz")
        np.savez(path, file_names=self.data_names, dts=self.dt)
        print("Summarise to: " + path)
