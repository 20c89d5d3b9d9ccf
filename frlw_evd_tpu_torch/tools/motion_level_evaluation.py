"""mAP stratified by motion level (counterpart of
tools/motion_level_evaluation.py; reference motion_level_evaluation.py).

Buckets GT and detections into 5 motion-density quintiles (hard-coded
percentile bounds) and runs the Prophesee COCO evaluation per bucket;
prints the 5 values as its last line. Host numpy.

    python -m frlw_evd_tpu_torch.tools.motion_level_evaluation \\
        -exp_name EXP [-dataset gen1] [-log_path log/] \\
        [-stats_dir statistics_result]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..evaluate.box_filtering import (filter_boxes, filter_boxes_gen1,
                                      filter_boxes_large)
from ..evaluate.coco_eval import evaluate_detection
from .motion_level import PERCENTILES

TOL = 4999

CLASSES = {
    "gen1": ["Car", "Pedestrian"],
    "gen1_mini": ["Car", "Pedestrian"],
    "gen4": ["pedestrian", "two wheeler", "car", "truck", "bus",
             "traffic sign", "traffic light"],
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-dataset", type=str, default="gen1")
    parser.add_argument("-exp_name", type=str, required=True)
    parser.add_argument("-log_path", type=str, default="log/")
    parser.add_argument("-stats_dir", type=str, default="statistics_result")
    args = parser.parse_args(argv)

    shape = (240, 304) if args.dataset.startswith("gen1") else (720, 1280)
    if args.dataset == "gen1_mini":
        # the mini tree's boxes are below the real GEN1 size thresholds
        filt = lambda b: filter_boxes(b, 0, 0, 0, 0)  # noqa: E731
    elif args.dataset == "gen1":
        filt = filter_boxes_gen1
    else:
        filt = filter_boxes_large
    classes = CLASSES[args.dataset]
    bounds = PERCENTILES[args.dataset]

    dt_dump = np.load(os.path.join(args.log_path, args.exp_name,
                                   "summarise_stats.npz"))
    dts = np.asarray(dt_dump["dts"], np.float64)
    dt_names = np.asarray(dt_dump["file_names"])
    dt_density = np.asarray(dt_dump["densitys"])

    gt_dump = np.load(os.path.join(args.stats_dir,
                                   f"gt_{args.dataset}.npz"))
    gts = np.asarray(gt_dump["gts"], np.float64)
    gt_names = np.asarray(gt_dump["file_names"])
    gt_density = np.asarray(gt_dump["densitys"])

    results = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        gt_list, dt_list = [], []
        for name in np.unique(gt_names):
            g = gts[(gt_names == name) & (gt_density >= lo)
                    & (gt_density < hi)]
            d = dts[(dt_names == name) & (dt_density >= lo)
                    & (dt_density < hi)]
            gt_list.append(g)
            dt_list.append(d)
        gt_f = list(map(filt, gt_list))
        dt_f = list(map(filt, dt_list))
        gt_keep, dt_keep = [], []
        for g, d in zip(gt_f, dt_f):
            if len(g) > 0:
                gt_keep.append(g)
                dt_keep.append(d if len(d) else
                               np.array([[g[0, 0], 0, 0, 0, 0, 0, 0, 0]]))
        if not gt_keep:
            results.append(float("nan"))
            continue
        stats = evaluate_detection(gt_keep, dt_keep, time_tol=TOL,
                                   classes=classes, height=shape[0],
                                   width=shape[1])
        results.append(float(stats[0]))
    print(results)
    return results


if __name__ == "__main__":
    main()
