"""1MEGAPIXEL dataset subsampler (counterpart of tools/sampling_dataset.py;
reference sampling_dataset.py), host numpy.

Keeps at most one annotation timestamp per sampling period (default 1 s)
and writes the event windows backing each kept annotation (count-bounded,
bin-aligned, with resume-across-timestamps) into new `.dat` + `_bbox.npy`
files. Skips annotations before 0.5 s (the evaluation skip window). The
labels live next to the events, as in the 1MEGAPIXEL layout.

    python -m frlw_evd_tpu_torch.tools.sampling_dataset -raw_dir RAW \\
        -target_dir OUT [-min_event_count 800000] \\
        [-sampling_period 1000000] [-height 720] [-width 1280]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..events import PSEELoader
from ..events.dat_codec import write_dat_header, write_event_buffer
from ..events.npy_codec import load_bboxes
from .generate_common import iter_streams


def main(argv=None):
    """Returns {"events": events written, "annotations": boxes written,
    "streams": files written}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", type=str, required=True)
    parser.add_argument("-target_dir", type=str, required=True)
    parser.add_argument("-min_event_count", type=int, default=800000)
    parser.add_argument("-sampling_period", type=int, default=1000000)
    parser.add_argument("-height", type=int, default=720)
    parser.add_argument("-width", type=int, default=1280)
    args = parser.parse_args(argv)

    events_window_abin = 10000
    events_window = events_window_abin * 5
    events_window_total = int(50000 + 16667 * 17)
    counts = {"events": 0, "annotations": 0, "streams": 0}

    for mode in ["train", "val", "test"]:
        target_root = os.path.join(args.target_dir, mode)
        os.makedirs(target_root, exist_ok=True)
        for name, event_path, bbox_path in iter_streams(args.raw_dir,
                                                        args.raw_dir, mode):
            boxes = load_bboxes(bbox_path)
            unique_ts = np.unique(boxes["t"])
            loader = PSEELoader(event_path)

            time_upperbound = -1e16
            count_upperbound = -1
            sampled_events = []
            sampled_boxes = []
            for bbox_count, unique_time in enumerate(unique_ts):
                if unique_time <= 500000:
                    continue
                if unique_time - time_upperbound < args.sampling_period:
                    continue
                end_time = int(unique_time)
                end_count = loader.seek_time(end_time)
                if end_count is None:
                    continue
                start_count = max(0, end_count - args.min_event_count)
                loader.seek_event(start_count)
                start_time = int(loader.current_time)
                if (end_time - start_time) < events_window_total:
                    start_time = end_time - events_window_total
                else:
                    start_time = end_time - round(
                        (end_time - start_time - events_window)
                        / events_window_abin) * events_window_abin \
                        - events_window

                if start_time > time_upperbound:
                    start_count = loader.seek_time(start_time)
                    if (start_count is None) or (start_time < 0):
                        start_count = 0
                else:
                    start_count = count_upperbound
                    start_time = time_upperbound
                    end_time = round((end_time - start_time)
                                     / events_window_abin) \
                        * events_window_abin + start_time
                    if end_time > loader.total_time():
                        end_time = loader.total_time()
                    end_count = loader.seek_time(end_time)
                    assert bbox_count > 0

                loader.seek_event(start_count)
                events = loader.load_n_events(int(end_count - start_count))
                sampled_events.append(events)
                sampled_boxes.append(boxes[boxes["t"] == unique_time])
                time_upperbound = end_time
                count_upperbound = end_count

            if not sampled_events:
                continue
            f = write_dat_header(os.path.join(target_root, name + "_td.dat"),
                                 height=args.height, width=args.width)
            events = np.concatenate(sampled_events)
            write_event_buffer(f, events)
            f.close()
            sampled = np.concatenate(sampled_boxes)
            np.save(os.path.join(target_root, name + "_bbox.npy"), sampled)
            counts["events"] += len(events)
            counts["annotations"] += len(sampled)
            counts["streams"] += 1
    return counts


if __name__ == "__main__":
    main()
