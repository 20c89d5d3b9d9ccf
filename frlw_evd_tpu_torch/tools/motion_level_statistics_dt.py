"""Per-detection motion density statistics (counterpart of
tools/motion_level_statistics_dt.py; reference
motion_level_statistics_dt.py).

Consumes the `summarise.npz` dump written by `cli.test --record True`,
matches detections to annotation timestamps ±4999 µs, overlap-dedups,
computes the per-box flow density and writes
`<log_path>/<exp>/summarise_stats.npz`. Host numpy.

    python -m frlw_evd_tpu_torch.tools.motion_level_statistics_dt \\
        -raw_dir RAW -exp_name EXP [-dataset gen1] [-log_path log/] \\
        [-flow_dir optical_flow_buffer]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..events.box_loading import boxes_to_array
from ..events.npy_codec import load_bboxes
from .generate_common import GEOMETRY, iter_streams
from .motion_level import box_flow_density, clip_box_xywh, overlap_dedup_nms

TOL = 4999


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", type=str, required=True)
    parser.add_argument("-dataset", type=str, default="gen1")
    parser.add_argument("-exp_name", type=str, required=True)
    parser.add_argument("-log_path", type=str, default="log/")
    parser.add_argument("-flow_dir", type=str, default="optical_flow_buffer")
    args = parser.parse_args(argv)

    shape = GEOMETRY[args.dataset]["shape"]
    result_path = os.path.join(args.log_path, args.exp_name, "summarise.npz")
    out_path = os.path.join(args.log_path, args.exp_name,
                            "summarise_stats.npz")

    dump = np.load(result_path)
    dts = np.asarray(dump["dts"], np.float64)
    dt_names = np.asarray(dump["file_names"])

    file_names2, dt_rows, densitys = [], [], []
    for name, event_path, bbox_path in iter_streams(args.raw_dir,
                                                    args.raw_dir, "test"):
        boxes = boxes_to_array(load_bboxes(bbox_path))
        dt_stream = dts[dt_names == name]
        for unique_time in np.unique(boxes[:, 0]):
            flow_path = os.path.join(args.flow_dir,
                                     f"{name}_{int(unique_time)}.npy")
            if not os.path.exists(flow_path):
                continue
            flow = np.load(flow_path)
            rows = dt_stream[(dt_stream[:, 0] >= unique_time - TOL)
                             & (dt_stream[:, 0] <= unique_time + TOL)]
            if len(rows) == 0:
                continue
            nms_rows = rows.copy()
            nms_rows[:, 3] = rows[:, 3] + rows[:, 1]
            nms_rows[:, 4] = rows[:, 4] + rows[:, 2]
            rows = rows[overlap_dedup_nms(nms_rows)].copy()
            for row in rows:
                x1, y1, x2, y2 = clip_box_xywh(row, shape)
                densitys.append(box_flow_density(flow, x1, y1, x2, y2))
                dt_rows.append(row)
                file_names2.append(name)

    np.savez(out_path, file_names=file_names2, dts=dt_rows, densitys=densitys)
    print("saved", out_path)
    return out_path


if __name__ == "__main__":
    main()
