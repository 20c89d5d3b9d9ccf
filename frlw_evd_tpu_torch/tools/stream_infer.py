"""Streaming inference: a raw .dat event file → detections, one recording
at batch 1 (counterpart of tools/stream_infer.py, the deployment form of
the encode → detect pipeline).

Per 10 ms window: slice the newest MAX_EVENTS events, update the unpacked
TAF queue (`encode.streaming.taf_stream_step`, whose histogram is kernel
B6 on the card), leaky transform and nearest resize, the AED forward in
f32, decode and NMS, then one host read of the detections, which ends the
window. Detections stream to stdout and optionally to a summarise-style
.npz (`dts` rows [t, cx, cy, w, h, cls, score], `file_names`).

    python -m frlw_evd_tpu_torch.tools.stream_infer -event_file seq_td.dat \\
        -dataset gen1 [-checkpoint log/exp/checkpoints/best_epoch] \\
        [-out dets.npz] [-max_windows 500] [-seq_nms] [-device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..encode.common import nearest_resize_indices
from ..encode.streaming import taf_pack_state, taf_stream_step
from ..encode.taf import INIT_VALUE, leaky_transform
from ..events import PSEELoader
from ..models import build_detector, eval_decode
from ..models.postprocess import finalize_detections, postprocess_batch
from ..models.seq_nms import SeqNMSState
from ..pipeline import (STRIDES, channels_last_, nearest_resize,
                        resolve_device)
from .generate_common import GEOMETRY

BIN_US = 10_000
K = 8
# events uploaded a window; 16k events / 10 ms covers GEN1 peak rates
MAX_EVENTS = 16384
MAX_DETECTIONS = 100


def geometry(dataset: str):
    """(sensor_hw the queue runs at, input_hw, classes): GEN1 encodes at
    the sensor and resizes; gen4 scales the events to the input."""
    geo = GEOMETRY[dataset]
    gen1 = dataset.startswith("gen1")
    return (geo["shape"] if gen1 else geo["target_shape"],
            geo["target_shape"], 2 if gen1 else 7)


def load_model(num_classes: int, checkpoint=None, *, device="cuda"):
    """The AED (stem bfm, 256 wide) in f32 eval mode on `device`: the
    model of a port .pth checkpoint (train.save_checkpoint's) when given,
    else seeded random weights (torch seed 0)."""
    dev = resolve_device(device)
    model = build_detector(num_classes, family="aed", stem="bfm")
    if checkpoint:
        ckpt = torch.load(os.path.abspath(checkpoint), map_location="cpu",
                          weights_only=True)
        model.load_state_dict(ckpt["model"])
    model.to(device=dev, dtype=torch.float32).eval()
    if dev.type == "cuda":
        channels_last_(model)
    return model


def make_window_step(model, sensor_hw, input_hw, conf: float = 0.3):
    """step(state, xytp (1, E, 4), n_valid (1,)) → (dets (1, 100, 6), keep
    (1, 100)), the queue `state` (1, H, W, 2, K) updated in place
    (tools/stream_infer.py:88-104)."""
    dev = next(model.parameters()).device
    ys, xs = nearest_resize_indices(sensor_hw, input_hw, dev)
    resize = tuple(input_hw) != tuple(sensor_hw)

    @torch.inference_mode()
    def step(state, xytp, n_valid):
        taf_stream_step(state, xytp, n_valid)
        vol = leaky_transform(taf_pack_state(state)) / 255.0
        if resize:
            vol = nearest_resize(vol, ys, xs)
        decoded = eval_decode([o.float() for o in model(vol)], STRIDES)
        return postprocess_batch(decoded, conf_threshold=conf,
                                 max_detections=MAX_DETECTIONS)

    return step


def window_events(events, t_end: int, dataset: str) -> tuple:
    """The newest MAX_EVENTS events of a window ending at t_end as (xytp
    (MAX_EVENTS, 4) f32 [x, y, t normalised to the window, p], n)."""
    xytp = np.zeros((MAX_EVENTS, 4), np.float32)
    n = min(len(events), MAX_EVENTS)
    if n:
        t_field = "ts" if "ts" in events.dtype.names else "t"
        sel = events[len(events) - n:]
        xytp[:n, 0] = sel["x"]
        xytp[:n, 1] = sel["y"]
        xytp[:n, 2] = (sel[t_field] - (t_end - BIN_US)) / BIN_US
        xytp[:n, 3] = sel["p"]
        if not dataset.startswith("gen1"):
            geo = GEOMETRY[dataset]
            xytp[:n, 0] *= geo["target_shape"][1] / geo["shape"][1]
            xytp[:n, 1] *= geo["target_shape"][0] / geo["shape"][0]
    return xytp, n


def stream_infer(event_file: str, dataset: str = "gen1", checkpoint=None,
                 out=None, max_windows: int = 200, conf: float = 0.3,
                 seq_nms: bool = False, *, device="cuda", model=None,
                 verbose: bool = True) -> dict:
    """Run the recording window by window. model: the AED to serve (f32,
    eval, on `device`), else `load_model`'s. Returns {"dets": per window
    the (n, 6) rows [cx, cy, w, h, cls, score] (one zero row when none is
    kept), "ts": window end times, "window_s": each window's host-clock
    seconds from its read of the file to its host read of the detections,
    "elapsed_s"}."""
    dev = resolve_device(device)
    sensor_hw, input_hw, nc = geometry(dataset)
    if model is None:
        model = load_model(nc, checkpoint, device=dev)
    step = make_window_step(model, sensor_hw, input_hw, conf)
    loader = PSEELoader(event_file)
    state = torch.full((1, *sensor_hw, 2, K), INIT_VALUE, dtype=torch.float32,
                       device=dev)
    seq = SeqNMSState() if seq_nms else None

    all_dets, all_ts, window_s = [], [], []
    t_wall = time.perf_counter()
    for _ in range(max_windows):
        if loader.done:
            break
        t0 = time.perf_counter()
        events = loader.load_delta_t(BIN_US)
        t_end = int(loader.current_time)
        xytp, n = window_events(events, t_end, dataset)
        dets, keep = step(state, torch.from_numpy(xytp)[None].to(dev),
                          torch.tensor([n], dtype=torch.int32, device=dev))
        det = finalize_detections(dets, keep)[0]
        window_s.append(time.perf_counter() - t0)
        if seq is not None:
            det = seq.link(det)
        if verbose and det.shape[0] and det[0, 5] > 0:
            for row in det:
                print(f"t={t_end} box=({row[0]:.1f},{row[1]:.1f},"
                      f"{row[2]:.1f},{row[3]:.1f}) cls={int(row[4])} "
                      f"score={row[5]:.3f}")
        all_dets.append(det)
        all_ts.append(t_end)
    elapsed = time.perf_counter() - t_wall
    n_windows = len(all_ts)
    print(f"# {n_windows} windows in {elapsed:.2f}s "
          f"({n_windows / max(elapsed, 1e-9):.1f} windows/s, batch 1)")

    if out:
        np.savez(out,
                 dts=np.concatenate([np.concatenate(
                     [np.full((len(d), 1), t), d], axis=1)
                     for d, t in zip(all_dets, all_ts)]) if all_dets else
                 np.zeros((0, 7)),
                 file_names=[os.path.basename(event_file)] * sum(
                     len(d) for d in all_dets))
        print("saved", out)
    return {"dets": all_dets, "ts": all_ts, "window_s": window_s,
            "elapsed_s": elapsed}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-event_file", required=True)
    parser.add_argument("-dataset", default="gen1", choices=sorted(GEOMETRY))
    parser.add_argument("-checkpoint", default=None,
                        help="a port .pth checkpoint (random init if absent)")
    parser.add_argument("-out", default=None)
    parser.add_argument("-max_windows", type=int, default=200)
    parser.add_argument("-conf", type=float, default=0.3)
    parser.add_argument("-seq_nms", action="store_true")
    parser.add_argument("-device", default="cuda")
    args = parser.parse_args(argv)
    return stream_infer(args.event_file, args.dataset, args.checkpoint,
                        args.out, args.max_windows, args.conf, args.seq_nms,
                        device=args.device)


if __name__ == "__main__":
    main()
