"""Offline Temporal Active Focus generator (counterpart of
tools/generate_taf.py; reference generate_taf.py).

Streaming per-pixel K=8 FIFO of 10 ms-bin activity with resume-across-
timestamps bookkeeping (reference :160-203): when the next annotation's
window overlaps the previous one, the queue state and event cursor carry
forward instead of re-encoding. Blobs are written split into `bins4`
(newest 4 bins) and `bins8` (older 4) so K=4 and K=8 models share files.
The queue runs on `-device` (default cuda, which raises without a card).

    python -m frlw_evd_tpu_torch.tools.generate_taf -raw_dir RAW \\
        -label_dir LABELS -target_dir OUT [-dataset gen1] [-device cuda]
"""

from __future__ import annotations

import os
import time

import torch

from ..encode.common import nearest_resize_chw
from ..encode.taf import (bucket_events_for_taf, encode_taf_window,
                          leaky_transform, taf_init_state)
from ..events import PSEELoader
from ..pipeline import resolve_device
from .generate_common import (SPLITS, count_blob, events_to_xytp, geometry,
                              iter_streams, new_stats, parse_args,
                              unique_annotation_times)

MIN_EVENT_COUNT = 50_000_000
BIN_US = 10_000
K = 8
MAX_EVENTS_PER_BIN = 2**17


def taf_finisher(enc_shape, target_shape, upscale: bool, K: int = K):
    """Queue (H', W', 2, K) → the (K, H, W) uint8 blob halves, newest bin
    first (oracle.taf_blob's layout), read to the host."""
    def finish(state):
        vol = state.permute(3, 2, 0, 1).reshape(2 * K, *enc_shape)
        if upscale:
            vol = nearest_resize_chw(vol, target_shape)
        vol = leaky_transform(vol.reshape(K, 2, *target_shape)).flip(0)
        half = K // 2
        new = vol[:half].reshape(half * 2, *target_shape).to(torch.uint8)
        old = vol[half:].reshape((K - half) * 2, *target_shape).to(
            torch.uint8)
        return new.cpu().numpy(), old.cpu().numpy()

    return finish


def generate_taf(raw_dir: str, label_dir: str, target_dir: str,
                 dataset: str = "gen1", device="cuda",
                 splits=SPLITS) -> dict:
    """Write the TAF blobs of every split under target_dir/taf. Returns
    generate_common.new_stats' counts, a blob being a bins4 / bins8
    pair."""
    dev = resolve_device(device)
    target_shape, rh, rw, upscale, enc_shape = geometry(dataset)
    events_window = BIN_US * K
    finish = taf_finisher(enc_shape, target_shape, upscale)

    out_dir = os.path.join(target_dir, "taf")
    stats = new_stats()
    for mode in splits:
        target_root = os.path.join(out_dir, mode)
        for b in (f"bins{K // 2}", f"bins{K}"):
            os.makedirs(os.path.join(target_root, b), exist_ok=True)
        for name, event_path, bbox_path in iter_streams(raw_dir, label_dir,
                                                        mode):
            unique_ts = unique_annotation_times(bbox_path)
            loader = PSEELoader(event_path)
            time_upperbound = -1e16
            count_upperbound = -1
            state = None

            for bbox_count, unique_time in enumerate(unique_ts):
                end_time = int(unique_time)
                end_count = loader.seek_time(end_time)
                if end_count is None:
                    continue
                start_count = max(0, end_count - MIN_EVENT_COUNT)
                loader.seek_event(start_count)
                start_time = int(loader.current_time)
                if (end_time - start_time) < events_window:
                    start_time = end_time - events_window
                else:
                    start_time = end_time - round(
                        (end_time - start_time - events_window) / BIN_US
                    ) * BIN_US - events_window

                if start_time > time_upperbound:
                    start_count = loader.seek_time(start_time)
                    if (start_count is None) or (start_time < 0):
                        start_count = 0
                    state = taf_init_state(*enc_shape, K, device=dev)
                else:
                    start_count = count_upperbound
                    start_time = time_upperbound
                    end_time = round((end_time - start_time) / BIN_US) \
                        * BIN_US + start_time
                    if end_time > loader.total_time():
                        end_time = loader.total_time()
                    end_count = loader.seek_time(end_time)
                    assert bbox_count > 0

                loader.seek_event(start_count)
                events = loader.load_n_events(int(end_count - start_count))
                xytp = events_to_xytp(events)
                if not upscale:
                    xytp[:, 0] *= rw
                    xytp[:, 1] *= rh

                binned, bin_valid = bucket_events_for_taf(
                    xytp, int(start_time), int(end_time), BIN_US,
                    MAX_EVENTS_PER_BIN)
                tick = time.perf_counter()
                state = encode_taf_window(
                    state, torch.from_numpy(binned).to(dev),
                    torch.from_numpy(bin_valid).to(dev))
                blob_new, blob_old = finish(state)
                count_blob(stats, mode, time.perf_counter() - tick)

                blob_new.tofile(os.path.join(
                    target_root, f"bins{K // 2}", f"{name}_{unique_time}.npy"))
                blob_old.tofile(os.path.join(
                    target_root, f"bins{K}", f"{name}_{unique_time}.npy"))

                time_upperbound = end_time
                count_upperbound = end_count
    if stats["test_blobs"]:
        print("Average Representation time: ",
              stats["test_encode_s"] / stats["test_blobs"])
    return stats


def main(argv=None):
    args = parse_args(argv)
    return generate_taf(args.raw_dir, args.label_dir, args.target_dir,
                        args.dataset, args.device)


if __name__ == "__main__":
    main()
