"""Offline Event Volume generator (counterpart of
tools/generate_eventvolume.py; reference generate_eventvolume.py).

For every annotation timestamp, load the trailing Δτ of events, normalise t
to [0, 1], splat onto 5 temporal bins on the device, clip at 255, truncate
to uint8 and write `EventVolume{Δτ}/{split}/<stream>_<ts>.npy` CHW blobs.
Δτ ∈ {250, 500, 1000} ms; a window keeps its newest MAX_EVENTS events,
as JAX's padding to MAX_EVENTS slots does, but is encoded at its own
length (eager PyTorch needs no fixed shape). GEN1 encodes at the sensor's
size, then nearest-resizes the volume; gen4 scales the coordinates
before encoding.
The encode runs on `-device` (default cuda, which raises without a card).

    python -m frlw_evd_tpu_torch.tools.generate_eventvolume -raw_dir RAW \\
        -label_dir LABELS -target_dir OUT [-dataset gen1] [-device cuda]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..encode.common import nearest_resize_hwc
from ..encode.event_volume import encode_event_volume
from ..events import PSEELoader
from ..pipeline import resolve_device
from .generate_common import (SPLITS, EncodeTimer, count_blob,
                              events_to_xytp, geometry, iter_streams,
                              new_stats, parse_args, unique_annotation_times)

TIME_WINDOWS = (250000, 500000, 1000000)
VOLUME_BINS = 5
MAX_EVENTS = 2**21


def generate_eventvolume(raw_dir: str, label_dir: str, target_dir: str,
                         dataset: str = "gen1", device="cuda") -> dict:
    """Write the EV blobs of every split and window under target_dir.
    Returns generate_common.new_stats' counts."""
    dev = resolve_device(device)
    target_shape, rh, rw, upscale, enc_shape = geometry(dataset)

    def encode(ev):
        vol = encode_event_volume(torch.from_numpy(ev).to(dev), len(ev),
                                  height=enc_shape[0], width=enc_shape[1],
                                  volume_bins=VOLUME_BINS)
        if upscale:
            vol = nearest_resize_hwc(vol, target_shape)
        # blob layout is CHW (the reference writes the permuted tensor)
        return vol.clamp(0, 255).to(torch.uint8).permute(2, 0, 1).cpu() \
            .numpy()

    timer = EncodeTimer(TIME_WINDOWS)
    stats = new_stats()
    for mode in SPLITS:
        for name, event_path, bbox_path in iter_streams(raw_dir, label_dir,
                                                        mode):
            loader = PSEELoader(event_path)
            for unique_time in unique_annotation_times(bbox_path):
                end_time = int(unique_time)
                if loader.seek_time(end_time) is None:
                    break
                start_time = max(0, end_time - max(TIME_WINDOWS))
                loader.seek_time(start_time)
                events = loader.load_delta_t(end_time - start_time)
                xytp = events_to_xytp(events)[-10_000_000:]
                for tw in TIME_WINDOWS:
                    ev = xytp[xytp[:, 2] > end_time - tw].copy()
                    ev[:, 2] = (ev[:, 2] - (end_time - tw)) / tw
                    if not upscale:
                        ev[:, 0] *= rw
                        ev[:, 1] *= rh
                    ev = ev[-MAX_EVENTS:].astype(np.float32)
                    tick = time.perf_counter()
                    blob = encode(ev)
                    took = time.perf_counter() - tick
                    count_blob(stats, mode, took)
                    if mode == "test":
                        timer.add(tw, took)
                    out_dir = os.path.join(target_dir, f"EventVolume{tw}",
                                           mode)
                    os.makedirs(out_dir, exist_ok=True)
                    blob.tofile(os.path.join(out_dir,
                                             f"{name}_{unique_time}.npy"))
    timer.report()
    return stats


def main(argv=None):
    args = parse_args(argv)
    return generate_eventvolume(args.raw_dir, args.label_dir,
                                args.target_dir, args.dataset, args.device)


if __name__ == "__main__":
    main()
