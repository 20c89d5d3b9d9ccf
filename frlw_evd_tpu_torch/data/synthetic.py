"""Synthetic GEN1-style dataset tree (the port's copy of the JAX package's
test fixture tests/fixtures.py::build_mini_gen1 and moving_box_events,
written with the port's own dat_codec and oracle, at any sensor and input
geometry).

Builds, under a root directory:
  events/{split}/<stream>_td.dat                   raw event streams
  labels/{split}/<stream>_bbox.npy                 annotations (BBOX_DTYPE)
  data/EventVolume250000/{split}/<stream>_<ts>.npy encoded EV blobs (oracle)
  data/taf/{split}/bins4,bins8/<stream>_<ts>.npy   encoded TAF blobs (oracle)

Events come from moving-box emitters, so detections are learnable and the
boxes match the event density. At the default arguments the tree is the
fixture's byte for byte (the .dat header's date line aside), for the same
numpy generator.
"""

from __future__ import annotations

import os

import numpy as np

from ..encode import oracle
from ..events import BBOX_DTYPE
from ..events.dat_codec import write_dat_file

SENSOR_HW = (60, 76)      # mini GEN1: same 240:304 aspect, 4x smaller
INPUT_HW = (64, 96)       # network input must be divisible by 32


def moving_box_events(rng, t0, t1, box, n_events, sensor_hw=SENSOR_HW):
    """Emit events uniformly inside a (possibly moving) box [x, y, w, h,
    vx, vy] over [t0, t1); returns sorted (ts, x, y, p)."""
    h, w = sensor_hw
    ts = np.sort(rng.integers(t0, t1, n_events)).astype(np.int64)
    frac = (ts - t0) / max(t1 - t0, 1)
    bx = box[0] + box[4] * frac
    by = box[1] + box[5] * frac
    x = (bx + rng.uniform(0, box[2], n_events)).astype(np.int64)
    y = (by + rng.uniform(0, box[3], n_events)).astype(np.int64)
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    p = rng.integers(0, 2, n_events)
    return ts, x, y, p


def build_mini_gen1(root, rng=None, streams=("seq0", "seq1"),
                    splits=("train", "val", "test"),
                    ann_times=(600_000, 700_000, 800_000),
                    duration=1_000_000, sensor_hw=SENSOR_HW,
                    input_hw=INPUT_HW, events_per_box=30_000,
                    noise_events=5000, blobs=("ev", "taf")):
    """Create the tree; returns its dict of paths (events, labels, ev_dir,
    taf_dir). Each stream holds two moving boxes of `events_per_box`
    events and `noise_events` of uniform noise over [0, duration) µs, with
    both boxes annotated at each of `ann_times`. blobs: the oracle blobs
    written, "ev" and / or "taf" (the oracle takes seconds a stream at
    the GEN1 sensor)."""
    rng = rng or np.random.default_rng(0)
    h, w = sensor_hw
    paths = {
        "events": os.path.join(root, "events"),
        "labels": os.path.join(root, "labels"),
        "ev_dir": os.path.join(root, "data", "EventVolume250000"),
        "taf_dir": os.path.join(root, "data", "taf"),
    }
    for split in splits:
        os.makedirs(os.path.join(paths["events"], split), exist_ok=True)
        os.makedirs(os.path.join(paths["labels"], split), exist_ok=True)
        os.makedirs(os.path.join(paths["ev_dir"], split), exist_ok=True)
        for b in ("bins4", "bins8"):
            os.makedirs(os.path.join(paths["taf_dir"], split, b),
                        exist_ok=True)

    # box specs scale with the sensor so they survive size filters at any
    # geometry (x, y, w, h, vx, vy as fractions of the 60x76 mini sensor)
    sx, sy = w / 76.0, h / 60.0
    boxes_spec = [
        (8 * sx, 10 * sy, 16 * sx, 12 * sy, 10 * sx, 4 * sy),
        (40 * sx, 30 * sy, 14 * sx, 14 * sy, -8 * sx, 6 * sy),
    ]
    for split in splits:
        for stream in streams:
            parts = [moving_box_events(rng, 0, duration, spec, events_per_box,
                                       sensor_hw) for spec in boxes_spec]
            ts, x, y, p = (np.concatenate(a) for a in zip(*parts))
            nts = rng.integers(0, duration, noise_events)
            ts = np.concatenate([ts, nts])
            x = np.concatenate([x, rng.integers(0, w, noise_events)])
            y = np.concatenate([y, rng.integers(0, h, noise_events)])
            p = np.concatenate([p, rng.integers(0, 2, noise_events)])
            order = np.argsort(ts, kind="stable")
            ts, x, y, p = ts[order], x[order], y[order], p[order]

            ev = np.empty(len(ts), dtype=[("ts", "u4"), ("x", "u2"),
                                          ("y", "u2"), ("p", "u1")])
            ev["ts"], ev["x"], ev["y"], ev["p"] = ts, x, y, p
            write_dat_file(os.path.join(paths["events"], split,
                                        f"{stream}_td.dat"), ev, h, w)

            # annotations at each ann time: box positions at that time
            boxes = np.zeros(len(ann_times) * len(boxes_spec),
                             dtype=BBOX_DTYPE)
            i = 0
            for t_ann in ann_times:
                frac = t_ann / duration
                for ci, spec in enumerate(boxes_spec):
                    (boxes["t"][i], boxes["x"][i], boxes["y"][i],
                     boxes["w"][i], boxes["h"][i], boxes["class_id"][i],
                     boxes["track_id"][i], boxes["class_confidence"][i]) = (
                        t_ann, spec[0] + spec[4] * frac,
                        spec[1] + spec[5] * frac, spec[2], spec[3], ci % 2,
                        ci + 1, 1.0)
                    i += 1
            np.save(os.path.join(paths["labels"], split,
                                 f"{stream}_bbox.npy"), boxes)

            xytp = np.stack([x, y, ts, p], -1).astype(np.float64)
            for t_ann in ann_times if "ev" in blobs else ():
                # Event Volume, 250 ms, 5 bins, encoded at sensor resolution
                # then nearest-resized to the input (the gen1 branch)
                win = xytp[(xytp[:, 2] > t_ann - 250_000)
                           & (xytp[:, 2] < t_ann)].copy()
                win[:, 2] = (win[:, 2] - (t_ann - 250_000)) / 250_000
                vol = oracle.event_volume(win.astype(np.float32), (h, w), 5)
                vol = oracle.nearest_resize(vol, input_hw)
                oracle.to_uint8(vol).tofile(os.path.join(
                    paths["ev_dir"], split, f"{stream}_{t_ann}.npy"))

            if "taf" in blobs:
                write_taf_blobs(xytp, ann_times, (h, w), input_hw,
                                paths["taf_dir"], split, stream)
    return paths


def write_taf_blobs(xytp, ann_times, sensor_hw, input_hw, taf_dir, split,
                    stream, bin_us=10_000, K=8):
    """Oracle TAF-K encode over one stream with the generator's
    resume-across-timestamps window logic (generate_taf.py:160-203), one
    bins{K/2} / bins{K} blob pair an annotation time."""
    events_window = bin_us * K
    state = None
    time_upperbound = -1e16
    t_first = float(xytp[0, 2]) if len(xytp) else 0.0

    for t_ann in ann_times:
        end_time = int(t_ann)
        # the count bound (50M events) covers a whole synthetic stream, so
        # the window starts at the first event, bin-aligned from end_time
        start_time = int(t_first)
        if (end_time - start_time) < events_window:
            start_time = end_time - events_window
        else:
            start_time = end_time - round(
                (end_time - start_time - events_window) / bin_us
            ) * bin_us - events_window

        if start_time > time_upperbound:
            state = oracle.taf_init_state(sensor_hw, K)
        else:
            start_time = int(time_upperbound)
            end_time = round((end_time - start_time) / bin_us) * bin_us \
                + start_time
            last_t = int(xytp[-1, 2]) if len(xytp) else end_time
            if end_time > last_t:
                end_time = last_t

        win = xytp[(xytp[:, 2] >= start_time)
                   & (xytp[:, 2] < end_time)].astype(np.float32)
        volume, state = oracle.taf_window(win, sensor_hw, start_time,
                                          end_time, bin_us, state)
        b_new, b_old = oracle.taf_blob(volume, K, target_hw=input_hw)
        b_new.tofile(os.path.join(taf_dir, split, f"bins{K // 2}",
                                  f"{stream}_{t_ann}.npy"))
        b_old.tofile(os.path.join(taf_dir, split, f"bins{K}",
                                  f"{stream}_{t_ann}.npy"))
        time_upperbound = end_time
