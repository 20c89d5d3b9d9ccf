"""Per-GT-box motion density statistics (counterpart of
tools/motion_level_statistics_gt.py; reference
motion_level_statistics_gt.py).

For every test annotation: overlap-dedup the GT boxes (clusters dropped),
clip to the sensor, compute mean flow magnitude per box from the cached
flow, save `<out_dir>/gt_<dataset>.npz` and print the density quantiles.
Host numpy.

    python -m frlw_evd_tpu_torch.tools.motion_level_statistics_gt \\
        -raw_dir RAW [-dataset gen1] [-flow_dir optical_flow_buffer] \\
        [-out_dir statistics_result]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..events.box_loading import boxes_to_array
from ..events.npy_codec import load_bboxes
from .generate_common import GEOMETRY, iter_streams
from .motion_level import box_flow_density, clip_box_xywh, overlap_dedup_nms


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", type=str, required=True)
    parser.add_argument("-dataset", type=str, default="gen1")
    parser.add_argument("-flow_dir", type=str, default="optical_flow_buffer")
    parser.add_argument("-out_dir", type=str, default="statistics_result")
    args = parser.parse_args(argv)

    shape = GEOMETRY[args.dataset]["shape"]
    os.makedirs(args.out_dir, exist_ok=True)

    file_names, gt_rows, densitys = [], [], []
    for name, event_path, bbox_path in iter_streams(args.raw_dir,
                                                    args.raw_dir, "test"):
        boxes = boxes_to_array(load_bboxes(bbox_path))
        for unique_time in np.unique(boxes[:, 0]):
            rows = boxes[boxes[:, 0] == unique_time]
            flow_path = os.path.join(args.flow_dir,
                                     f"{name}_{int(unique_time)}.npy")
            if not os.path.exists(flow_path):
                continue
            flow = np.load(flow_path)
            nms_rows = rows.copy()
            nms_rows[:, 3] = rows[:, 3] + rows[:, 1]
            nms_rows[:, 4] = rows[:, 4] + rows[:, 2]
            rows = rows[overlap_dedup_nms(nms_rows)]
            for row in rows:
                x1, y1, x2, y2 = clip_box_xywh(row, shape)
                file_names.append(name)
                gt_rows.append(row)
                densitys.append(box_flow_density(flow, x1, y1, x2, y2))

    out_path = os.path.join(args.out_dir, f"gt_{args.dataset}.npz")
    print([np.quantile(densitys, q / 100) for q in range(0, 100, 5)])
    np.savez(out_path, file_names=file_names, gts=gt_rows, densitys=densitys)
    print("saved", out_path)
    return out_path


if __name__ == "__main__":
    main()
