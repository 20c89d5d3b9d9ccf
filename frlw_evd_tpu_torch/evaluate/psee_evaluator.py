"""Standalone GT-folder vs DT-folder mAP CLI (a copy of
frlw_evd_tpu/evaluate/psee_evaluator.py; reference:
evaluate/src/psee_evaluator.py).

Usage: python -m frlw_evd_tpu_torch.evaluate.psee_evaluator GT_DIR DT_DIR
       [--dataset gen1|gen4] [--time_tol 4999]
"""

from __future__ import annotations

import argparse
import glob
import os

from ..events.box_loading import boxes_to_array
from ..events.npy_codec import load_bboxes
from .box_filtering import filter_boxes_gen1, filter_boxes_large
from .coco_eval import evaluate_detection

GEN1_CLASSES = ("car", "pedestrian")
GEN4_CLASSES = ("pedestrian", "two wheeler", "car", "truck", "bus",
                "traffic sign", "traffic light")


def evaluate_folders(dt_folder, gt_folder, time_tol, dataset="gen1"):
    dt_files = sorted(glob.glob(os.path.join(dt_folder, "*.npy")))
    gt_files = sorted(glob.glob(os.path.join(gt_folder, "*.npy")))
    assert len(dt_files) == len(gt_files), "folders must pair 1:1"
    filt = filter_boxes_gen1 if dataset == "gen1" else filter_boxes_large
    classes = GEN1_CLASSES if dataset == "gen1" else GEN4_CLASSES
    hw = (240, 304) if dataset == "gen1" else (720, 1280)

    gts = [filt(boxes_to_array(load_bboxes(p))) for p in gt_files]
    dts = [filt(boxes_to_array(load_bboxes(p))) for p in dt_files]
    result = evaluate_detection(gts, dts, classes=classes, height=hw[0],
                                width=hw[1], time_tol=time_tol)
    print("COCO stats:", result)
    return result


def main():
    parser = argparse.ArgumentParser(description="psee folder evaluator")
    parser.add_argument("gt_folder")
    parser.add_argument("dt_folder")
    parser.add_argument("--dataset", default="gen1")
    parser.add_argument("--time_tol", type=int, default=4999)
    args = parser.parse_args()
    evaluate_folders(args.dt_folder, args.gt_folder, args.time_tol,
                     args.dataset)


if __name__ == "__main__":
    main()
