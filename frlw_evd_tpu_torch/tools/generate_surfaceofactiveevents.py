"""Offline Surface of Active Events generator (counterpart of
tools/generate_surfaceofactiveevents.py; reference
generate_surfaceofactiveevents.py).

Per annotation timestamp: take the trailing 5 s of events, scatter-max the
last event's timestamp per (pixel, polarity) on the device, max-merge with
the stream's memory (carried from one annotation time to the next), decay
with λ ∈ {1e-5, 2.5e-6, 1e-6} and write a 2-channel uint8 CHW blob per λ
under `SurfaceOfActiveEvents{λ}/{split}/`. An encode keeps its newest
MAX_EVENTS events, as JAX's padding to MAX_EVENTS slots does, at its own
length. The encode runs on `-device`
(default cuda, which raises without a card).

    python -m frlw_evd_tpu_torch.tools.generate_surfaceofactiveevents \\
        -raw_dir RAW -label_dir LABELS -target_dir OUT [-dataset gen1] \\
        [-device cuda]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..encode.common import nearest_resize_hwc
from ..encode.sae import encode_sae, sae_init_state
from ..events import PSEELoader
from ..pipeline import resolve_device
from .generate_common import (SPLITS, EncodeTimer, count_blob,
                              events_to_xytp, geometry, iter_streams,
                              new_stats, parse_args, unique_annotation_times)

LAMDAS = (0.00001, 0.0000025, 0.000001)
EVENTS_WINDOW = 5_000_000
MAX_EVENTS = 2**22


def generate_surfaceofactiveevents(raw_dir: str, label_dir: str,
                                   target_dir: str, dataset: str = "gen1",
                                   device="cuda") -> dict:
    """Write the SAE blobs of every split and λ under target_dir. Returns
    generate_common.new_stats' counts, a blob being one annotation time's
    encode (all three λ)."""
    dev = resolve_device(device)
    target_shape, rh, rw, upscale, enc_shape = geometry(dataset)

    def encode(ev, memory, now):
        ecd, memory = encode_sae(torch.from_numpy(ev).to(dev), len(ev),
                                 memory, now, height=enc_shape[0],
                                 width=enc_shape[1], lamdas=LAMDAS)
        if upscale:
            ecd = nearest_resize_hwc(ecd, target_shape)
        return ecd.to(torch.uint8).cpu().numpy(), memory

    timer = EncodeTimer(LAMDAS)
    stats = new_stats()
    for mode in SPLITS:
        for name, event_path, bbox_path in iter_streams(raw_dir, label_dir,
                                                        mode):
            loader = PSEELoader(event_path)
            time_upper_bound = -100000000
            count_upper_bound = 0
            memory = None
            for unique_time in unique_annotation_times(bbox_path):
                end_time = int(unique_time)
                end_count = loader.seek_time(end_time)
                if end_count is None:
                    continue
                start_time = end_time - EVENTS_WINDOW
                start_count = (loader.seek_time(start_time)
                               if start_time >= 0 else 0) or 0
                if start_time <= time_upper_bound:
                    start_count = count_upper_bound
                loader.seek_event(start_count)
                events = loader.load_n_events(int(end_count - start_count))
                ev = events_to_xytp(events)
                time_upper_bound = unique_time
                count_upper_bound = end_count
                if not upscale:
                    ev[:, 0] *= rw
                    ev[:, 1] *= rh
                if memory is None:
                    memory = sae_init_state(*enc_shape, now=float(unique_time),
                                            device=dev)
                ev = ev[-MAX_EVENTS:].astype(np.float32)
                tick = time.perf_counter()
                ecd, memory = encode(ev, memory, np.float32(unique_time))
                took = time.perf_counter() - tick
                count_blob(stats, mode, took)
                if mode == "test":
                    timer.add(LAMDAS[0], took)
                for j, lam in enumerate(LAMDAS):       # c = 2 * lam + p
                    out_dir = os.path.join(target_dir,
                                           f"SurfaceOfActiveEvents{lam}", mode)
                    os.makedirs(out_dir, exist_ok=True)
                    ecd[:, :, 2 * j:2 * j + 2].transpose(2, 0, 1).tofile(
                        os.path.join(out_dir, f"{name}_{unique_time}.npy"))
    timer.report()
    return stats


def main(argv=None):
    args = parse_args(argv)
    return generate_surfaceofactiveevents(args.raw_dir, args.label_dir,
                                          args.target_dir, args.dataset,
                                          args.device)


if __name__ == "__main__":
    main()
