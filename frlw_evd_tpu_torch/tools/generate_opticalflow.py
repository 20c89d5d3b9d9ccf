"""Optical flow per annotation timestamp (counterpart of
tools/generate_opticalflow.py; reference generate_opticalflow.py).

For the test split, builds a pair of event time surfaces 50 ms apart ending
at each annotation, computes dense optical flow between them and caches
`<out_dir>/<stream>_<ts>.npy` ((H, W, 2) f32) for the motion-level
statistics. The surfaces and the flow (tools/farneback.py) run on -device
(default cuda, which raises without a card).

    python -m frlw_evd_tpu_torch.tools.generate_opticalflow -raw_dir RAW \\
        [-label_dir LABELS] [-dataset gen1] [-out_dir optical_flow_buffer] \\
        [-device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..events import PSEELoader
from ..pipeline import resolve_device
from .generate_common import (GEOMETRY, events_to_xytp, iter_streams,
                              unique_annotation_times)
from .motion_level import generate_timesurface
from .farneback import farneback_flow

WINDOW = 500000  # µs of history per surface pair


def generate_opticalflow(raw_dir: str, label_dir: str, dataset: str = "gen1",
                         out_dir: str = "optical_flow_buffer",
                         device="cuda") -> int:
    """Write the flow of every test annotation not cached yet; returns the
    number written."""
    dev = resolve_device(device)
    shape = GEOMETRY[dataset]["shape"]
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for name, event_path, bbox_path in iter_streams(raw_dir, label_dir,
                                                    "test"):
        unique_ts = unique_annotation_times(bbox_path)
        loader = PSEELoader(event_path)
        for unique_time in unique_ts:
            out_path = os.path.join(out_dir, f"{name}_{int(unique_time)}.npy")
            if os.path.exists(out_path):
                continue
            end_time = int(unique_time)
            start_time = end_time - WINDOW
            loader.seek_time(start_time)
            events = loader.load_delta_t(end_time - start_time)
            xytp = events_to_xytp(events)
            xytp = xytp[(xytp[:, 0] < shape[1]) & (xytp[:, 1] < shape[0])]
            v1, v2 = generate_timesurface(xytp, shape, dev)
            flow = farneback_flow(v1.to(torch.uint8), v2.to(torch.uint8),
                                  dev)
            np.save(out_path, flow.cpu().numpy(), allow_pickle=True)
            written += 1
    return written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", type=str, required=True)
    parser.add_argument("-label_dir", type=str, default=None)
    parser.add_argument("-dataset", type=str, default="gen1",
                        choices=sorted(GEOMETRY))
    parser.add_argument("-out_dir", type=str, default="optical_flow_buffer")
    parser.add_argument("-device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return generate_opticalflow(args.raw_dir, args.label_dir or args.raw_dir,
                                args.dataset, args.out_dir, args.device)


if __name__ == "__main__":
    main()
