"""Checkpoint dress rehearsal (counterpart of tools/dress_rehearsal.py): raw
`.dat` + bbox `.npy` (+ an optional released `.pth` or a port checkpoint)
→ TAF encode → eval → Prophesee COCO mAP, in one command.

The TAF encode keeps the reference's per-annotation window logic
(count-bounded backward seek, bin alignment, resume from the previous
timestamp; generate_taf.py:160-203) and runs the queue on -device with
encode/taf.py, as tools/generate_taf.py does; on the CPU its blobs equal
the numpy oracle's, which the JAX tool feeds. The AED (stem bfm) runs in
f32 on -device (default cuda, which raises without a card). `.pth` files
load through train.checkpoints.import_torch_checkpoint; any other
-checkpoint is a port checkpoint (train.save_checkpoint's: its EMA
parameters when it holds them, as JAX's best state holds them), where
the JAX tool takes an Orbax directory.

    python -m frlw_evd_tpu_torch.tools.dress_rehearsal -raw_dir events/ \\
        -label_dir labels/ -dataset gen1 [-checkpoint AED_TAF_K8_GEN1.pth] \\
        [-split test] [-bins 8] [-max_streams 4] [-device cuda]

Prints the JAX tool's JSON line (metric, value, windows, streams, stats),
and before it a line `# encode ... ms/window, detect ... ms/window` (host
clock: the encode up to its blob's host read, the detect up to the
detections' host read).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..evaluate import box_filtering as _bf
from ..evaluate.evaluator import Evaluator
from ..events import PSEELoader
from ..events.npy_codec import load_bboxes
from ..models import build_detector
from ..models.detector import eval_decode
from ..models.postprocess import finalize_detections, postprocess_batch
from ..pipeline import channels_last_, resolve_device
from .generate_common import GEOMETRY, iter_streams
from .generate_taf import MAX_EVENTS_PER_BIN, taf_finisher
from ..encode.taf import (bucket_events_for_taf, encode_taf_window,
                          taf_init_state)

CLASSES = {"gen1": ("car", "pedestrian"),
           "gen4": ("pedestrian", "two wheeler", "car", "truck", "bus",
                    "traffic sign", "traffic light")}
MIN_EVENT_COUNT = 50_000_000


def encode_stream_taf(event_path, ann_times, sensor_hw, target_hw, bin_us, K,
                      device="cuda"):
    """Per-annotation TAF volumes with the reference resume logic
    (dress_rehearsal.py:43-94), the queue on `device` at the sensor's size
    and the volume nearest-resized to target_hw.

    Yields (t_ann, volume (2K, Ht, Wt) uint8 numpy in blob channel order:
    newest bin first, c = 2*age + p)."""
    dev = resolve_device(device)
    finish = taf_finisher(tuple(sensor_hw), tuple(target_hw), True, K)
    loader = PSEELoader(event_path)
    events_window = bin_us * K
    h, w = sensor_hw
    state = None
    time_upperbound = -1e16
    count_upperbound = -1

    for t_ann in ann_times:
        end_time = int(t_ann)
        end_count = loader.seek_time(end_time)
        if end_count is None:
            continue
        start_count = max(end_count - MIN_EVENT_COUNT, 0)
        loader.seek_event(start_count)
        start_time = int(loader.current_time)
        if (end_time - start_time) < events_window:
            start_time = end_time - events_window
        else:
            start_time = end_time - round(
                (end_time - start_time - events_window) / bin_us
            ) * bin_us - events_window

        if start_time > time_upperbound:
            start_count = loader.seek_time(start_time)
            if start_count is None or start_time < 0:
                start_count = 0
            state = taf_init_state(h, w, K, device=dev)
        else:
            start_count = count_upperbound
            start_time = int(time_upperbound)
            end_time = round((end_time - start_time) / bin_us) * bin_us \
                + start_time
            if end_time > loader.total_time():
                end_time = int(loader.total_time())
            end_count = loader.seek_time(end_time)

        loader.seek_event(start_count)
        ev = loader.load_n_events(int(end_count - start_count))
        xytp = np.stack([ev["x"], ev["y"], ev["ts"], ev["p"]],
                        axis=-1).astype(np.float32)

        binned, bin_valid = bucket_events_for_taf(
            xytp, start_time, end_time, bin_us, MAX_EVENTS_PER_BIN)
        state = encode_taf_window(state, torch.from_numpy(binned).to(dev),
                                  torch.from_numpy(bin_valid).to(dev))
        b_new, b_old = finish(state)
        time_upperbound = end_time
        count_upperbound = end_count
        yield t_ann, np.concatenate([b_new, b_old], axis=0)


def iter_blob_windows(blob_root, split, stream, ann_times, K, target_hw):
    """Read precomputed TAF blobs in the reference's on-disk layout
    (target_dir/taf/<split>/bins{K/2}|bins{K}/<stream>_<t>.npy raw uint8,
    reference data/dataset.py:294-307 / generate_taf.py:231-235). Yields
    (t_ann, (2K, Ht, Wt) uint8) — drop-in for encode_stream_taf."""
    h, w = target_hw
    half = K // 2
    for t_ann in ann_times:
        p_new = os.path.join(blob_root, split, f"bins{half}",
                             f"{stream}_{t_ann}.npy")
        p_old = os.path.join(blob_root, split, f"bins{K}",
                             f"{stream}_{t_ann}.npy")
        if not (os.path.exists(p_new) and os.path.exists(p_old)):
            continue
        b_new = np.fromfile(p_new, np.uint8).reshape(half * 2, h, w)
        b_old = np.fromfile(p_old, np.uint8).reshape((K - half) * 2, h, w)
        yield t_ann, np.concatenate([b_new, b_old], axis=0)


def iter_label_streams(label_dir, split):
    """Stream enumeration from labels only (blob mode needs no raw events)."""
    root = os.path.join(label_dir, split)
    if not os.path.isdir(root):
        return
    for f in sorted(os.listdir(root)):
        if f.endswith("_bbox.npy"):
            name = f[:-len("_bbox.npy")]
            yield name, None, os.path.join(root, f)


def load_model(num_classes: int, K: int, checkpoint=None, *, device="cuda"):
    """The AED (stem bfm, 256 wide, 2K input channels) in f32 eval mode on
    `device`: a reference .pth imported, a port checkpoint loaded, or the
    seeded init (torch seed 0) when no checkpoint is given."""
    from ..train.checkpoints import import_torch_checkpoint

    dev = resolve_device(device)
    model = build_detector(num_classes, family="aed", stem="bfm",
                           input_channels=2 * K)
    if checkpoint and checkpoint.endswith(".pth"):
        report = import_torch_checkpoint(checkpoint, model)
        print(f"imported {report['loaded']} tensors from {checkpoint}; "
              f"unmatched: {len(report['unmatched'])}")
    elif checkpoint:
        ckpt = torch.load(os.path.abspath(checkpoint), map_location="cpu",
                          weights_only=True)
        model.load_state_dict(ckpt["model"])
        if ckpt.get("ema") is not None:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(ckpt["ema"][k])
    else:
        print("NOTE: random init (no -checkpoint) — mAP will be ~0; this "
              "exercises the pipeline only")
    model.to(device=dev, dtype=torch.float32).eval()
    if dev.type == "cuda":
        channels_last_(model)
    return model


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-raw_dir", default=None,
                        help="raw .dat tree (omit with -blob_dir)")
    parser.add_argument("-label_dir", required=True)
    parser.add_argument("-blob_dir", default=None,
                        help="precomputed TAF blob tree in the reference "
                             "layout (<dir>/<split>/bins4,bins8/...); skips "
                             "the encode stage")
    parser.add_argument("-dataset", default="gen1", choices=("gen1", "gen4"))
    parser.add_argument("-checkpoint", default=None,
                        help=".pth (reference import) or a port checkpoint")
    parser.add_argument("-split", default="test")
    parser.add_argument("-bins", type=int, default=8)
    parser.add_argument("-infer_time", type=int, default=10_000)
    parser.add_argument("-max_streams", type=int, default=0)
    parser.add_argument("-eval_filter", default=None,
                        choices=("gen1", "gen4", "kitti", "none"),
                        help="override the box-size filter (mini trees "
                             "need 'none': gen1 drops diag<30)")
    parser.add_argument("-sensor_hw", default=None,
                        help="override 'H,W' (e.g. mini trees)")
    parser.add_argument("-input_hw", default=None)
    parser.add_argument("-device", default="cuda")
    args = parser.parse_args(argv)
    if args.raw_dir is None and args.blob_dir is None:
        parser.error("need -raw_dir (encode) or -blob_dir (precomputed)")
    return args


def dress_rehearsal(args, model=None) -> dict:
    """Run the rehearsal of parsed `args`; model: the AED to serve (f32,
    eval, on the device), else load_model's. Returns the printed result
    with "encode_ms" and "detect_ms" a window and "dets" (per window the
    finalized rows) added."""
    dev = resolve_device(args.device)
    geom = GEOMETRY[args.dataset]
    sensor_hw = tuple(int(v) for v in args.sensor_hw.split(",")) \
        if args.sensor_hw else geom["shape"]
    input_hw = tuple(int(v) for v in args.input_hw.split(",")) \
        if args.input_hw else geom["target_shape"]
    classes = CLASSES[args.dataset]
    K = args.bins
    if model is None:
        model = load_model(len(classes), K, args.checkpoint, device=dev)

    @torch.inference_mode()
    def forward(vol):
        outs = [o.float() for o in model(vol)]
        decoded = eval_decode(outs, (8, 16, 32))
        return postprocess_batch(decoded, max_detections=100)

    evaluator = Evaluator(classes, 1, args.infer_time,
                          sensor_hw[1], sensor_hw[0],
                          input_hw[1], input_hw[0], dataset=args.dataset)
    if args.eval_filter == "none":
        evaluator.filter_boxes = lambda b: _bf.filter_boxes(b, 0, 0, 0, 0)
    elif args.eval_filter:
        evaluator.filter_boxes = {"gen1": _bf.filter_boxes_gen1,
                                  "gen4": _bf.filter_boxes_large,
                                  "kitti": _bf.filter_boxes_kitti
                                  }[args.eval_filter]

    n_streams = 0
    n_windows = 0
    encode_s = detect_s = 0.0
    all_dets = []
    streams = (iter_label_streams(args.label_dir, args.split)
               if args.blob_dir else
               iter_streams(args.raw_dir, args.label_dir, args.split))
    for stream, event_path, bbox_path in streams:
        if args.max_streams and n_streams >= args.max_streams:
            break
        n_streams += 1
        boxes = load_bboxes(bbox_path)
        ann_times = np.unique(boxes["t"])
        rh = input_hw[0] / sensor_hw[0]
        rw = input_hw[1] / sensor_hw[1]
        windows = (iter_blob_windows(args.blob_dir, args.split, stream,
                                     ann_times, K, input_hw)
                   if args.blob_dir else
                   encode_stream_taf(event_path, ann_times, sensor_hw,
                                     input_hw, args.infer_time, K, dev))
        t_enc = time.perf_counter()
        for t_ann, blob in windows:
            encode_s += time.perf_counter() - t_enc
            vol = (torch.from_numpy(blob.astype(np.float32) / 255.0)
                   .permute(1, 2, 0)[None].to(dev))
            t0 = time.time()
            dets, keep = forward(vol)
            dets = finalize_detections(dets, keep)
            infer = time.time() - t0
            detect_s += infer
            rows = boxes[boxes["t"] == t_ann]
            # eval label rows: (cx, cy, w, h, cls, t, track, conf) at input res
            gt = np.zeros((len(rows), 8), np.float64)
            gt[:, 0] = (rows["x"] + rows["w"] / 2) * rw
            gt[:, 1] = (rows["y"] + rows["h"] / 2) * rh
            gt[:, 2] = rows["w"] * rw
            gt[:, 3] = rows["h"] * rh
            gt[:, 4] = rows["class_id"]
            gt[:, 5] = rows["t"]
            gt[:, 6] = rows["track_id"]
            gt[:, 7] = rows["class_confidence"]
            evaluator.add_result([dets[0]], [t_ann], [gt], [stream],
                                 infer, 0.0)
            all_dets.append(dets[0])
            n_windows += 1
            t_enc = time.perf_counter()

    if n_windows == 0:
        print("no evaluable windows found", file=sys.stderr)
        sys.exit(1)
    stats = evaluator.evaluate()
    result = {"metric": f"{args.dataset}_dress_rehearsal_mAP",
              "value": round(float(stats[0]), 4),
              "windows": n_windows, "streams": n_streams,
              "stats": [round(float(s), 4) for s in stats]}
    encode_ms = encode_s / n_windows * 1e3
    detect_ms = detect_s / n_windows * 1e3
    print(f"# encode {encode_ms:.3f} ms/window"
          f"{' (blob reads)' if args.blob_dir else ''}, detect "
          f"{detect_ms:.3f} ms/window on {dev}")
    print(json.dumps(result))
    return {**result, "mAP": float(stats[0]), "encode_ms": encode_ms,
            "detect_ms": detect_ms, "dets": all_dets}


def main(argv=None):
    return dress_rehearsal(parse_args(argv))


if __name__ == "__main__":
    main()
