"""Offline Event Count Image generator (counterpart of
tools/generate_eventcountimage.py; reference generate_eventcountimage.py).

Count-bounded windows: for each annotation timestamp take the last N events
(N ∈ {5e4, 1e5, 2e5} GEN1 / {4e5, 8e5, 1.2e6} gen4), add 0.05 per event on
the device, clamp at 1, x255 → a 2-channel uint8 CHW blob under
`EventCountImage{N}/{split}/`. Within a stream the last max(N) events are
kept and put in front of the next window's. A window is encoded at its
own length, where JAX pads it to max(N) slots. The encode runs on `-device`
(default cuda, which raises without a card).

    python -m frlw_evd_tpu_torch.tools.generate_eventcountimage \\
        -raw_dir RAW -label_dir LABELS -target_dir OUT [-dataset gen1] \\
        [-device cuda]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..encode.common import nearest_resize_hwc
from ..encode.count_image import encode_count_image
from ..events import PSEELoader
from ..pipeline import resolve_device
from .generate_common import (SPLITS, EncodeTimer, count_blob,
                              events_to_xytp, geometry, iter_streams,
                              new_stats, parse_args, unique_annotation_times)


def count_windows(dataset: str) -> list[int]:
    return ([400000, 800000, 1200000] if dataset == "gen4"
            else [50000, 100000, 200000])


def generate_eventcountimage(raw_dir: str, label_dir: str, target_dir: str,
                             dataset: str = "gen1", device="cuda") -> dict:
    """Write the ECI blobs of every split and window under target_dir.
    Returns generate_common.new_stats' counts."""
    dev = resolve_device(device)
    target_shape, rh, rw, upscale, enc_shape = geometry(dataset)
    windows = count_windows(dataset)
    max_events = max(windows)

    def encode(ev):
        vol = encode_count_image(torch.from_numpy(ev).to(dev), len(ev),
                                 height=enc_shape[0], width=enc_shape[1])
        if upscale:
            vol = nearest_resize_hwc(vol, target_shape)
        return vol.to(torch.uint8).permute(2, 0, 1).cpu().numpy()

    timer = EncodeTimer(windows)
    stats = new_stats()
    for mode in SPLITS:
        for name, event_path, bbox_path in iter_streams(raw_dir, label_dir,
                                                        mode):
            loader = PSEELoader(event_path)
            count_upper_bound = -100000000
            memory = None
            for unique_time in unique_annotation_times(bbox_path):
                end_count = loader.seek_time(int(unique_time))
                if end_count is None:
                    break
                start_count = max(0, int(end_count - max_events))
                if start_count <= count_upper_bound:
                    start_count = count_upper_bound
                loader.seek_event(start_count)
                events = loader.load_n_events(int(end_count - start_count))
                xytp = events_to_xytp(events)
                if memory is not None:
                    xytp = np.concatenate([memory, xytp])
                memory = xytp[-max_events:]
                count_upper_bound = end_count
                for n_window in windows:
                    ev = xytp[-n_window:].copy()
                    if not upscale:
                        ev[:, 0] *= rw
                        ev[:, 1] *= rh
                    ev = ev.astype(np.float32)
                    tick = time.perf_counter()
                    blob = encode(ev)
                    took = time.perf_counter() - tick
                    count_blob(stats, mode, took)
                    if mode == "test":
                        timer.add(n_window, took)
                    out_dir = os.path.join(target_dir,
                                           f"EventCountImage{n_window}", mode)
                    os.makedirs(out_dir, exist_ok=True)
                    blob.tofile(os.path.join(out_dir,
                                             f"{name}_{unique_time}.npy"))
    timer.report()
    return stats


def main(argv=None):
    args = parse_args(argv)
    return generate_eventcountimage(args.raw_dir, args.label_dir,
                                    args.target_dir, args.dataset,
                                    args.device)


if __name__ == "__main__":
    main()
