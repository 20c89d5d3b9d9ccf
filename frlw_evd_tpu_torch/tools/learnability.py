"""Learnability validation (counterpart of tools/learnability.py): train
the AED on Event Volume blobs of a synthetic GEN1-like dataset to high
AP50 on a held-out val split — evidence that the trainer reaches real
optima, not just that the loss plumbing coheres.

Builds the dataset with data/synthetic.build_mini_gen1 (moving boxes +
noise, deterministic: the JAX test fixture's tree for the same seed),
trains with the port's Trainer (make_config("basic"), yoloxwarmcos,
SimOTA, COCO eval every -eval_every epochs) on -device (default cuda,
which raises without a card) and prints one JSON line {"metric", "value"
(the best epoch's AP50), "map", "best_epoch", "streams", "epochs"}. With
-int8_eval the final weights (the EMA's when kept) are calibrated on two
val batches, quantized and evaluated again through
make_eval_step(quant=...) — int8_conv2d at every calibrated site — adding
map_f32_final, ap50_f32_final, map_int8 and ap50_int8. The JAX tool's -rng
(its dropout bit generator) has no counterpart.

    python -m frlw_evd_tpu_torch.tools.learnability [-streams 50] \\
        [-epochs 12] [-out DIR] [-int8_eval] [-device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data.synthetic import INPUT_HW, SENSOR_HW, build_mini_gen1
from ..evaluate.box_filtering import filter_boxes
from ..models.blocks import space_to_depth_patches
from ..models.quantize import build_weight_table, calibrate_int8
from ..pipeline import resolve_device
from ..train import make_config
from ..train.trainer import Trainer, make_eval_step


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-streams", type=int, default=50)
    parser.add_argument("-epochs", type=int, default=12)
    parser.add_argument("-batch", type=int, default=16)
    parser.add_argument("-lr", type=float, default=2e-3)
    parser.add_argument("-out", default=os.path.join("build", "learnability"))
    parser.add_argument("-ann_per_stream", type=int, default=6)
    parser.add_argument("-eval_every", type=int, default=5)
    parser.add_argument("-no_augment", action="store_true")
    parser.add_argument("-int8_eval", action="store_true",
                        help="after training, re-evaluate the trained model "
                             "through the post-training int8 path "
                             "(models/quantize.py) and report map_int8")
    parser.add_argument("-device", default="cuda")
    return parser.parse_args(argv)


def _no_filter(boxes):
    return filter_boxes(boxes, 0, 0, 0, 0)


def learnability(args) -> dict:
    dev = resolve_device(args.device)
    root = os.path.join(args.out, "data")
    marker = os.path.join(root, ".done")
    rng = np.random.default_rng(7)
    if not os.path.exists(marker):
        os.makedirs(root, exist_ok=True)
        ann = tuple(600_000 + 40_000 * i for i in range(args.ann_per_stream))
        print(f"building {args.streams}-stream synthetic dataset ...",
              file=sys.stderr)
        build_mini_gen1(root, rng=rng,
                        streams=tuple(f"s{i:03d}" for i in range(args.streams)),
                        splits=("train",), ann_times=ann)
        build_mini_gen1(root, rng=rng,
                        streams=tuple(f"v{i:02d}" for i in
                                      range(max(args.streams // 5, 2))),
                        splits=("val",), ann_times=ann)
        with open(marker, "w") as f:
            f.write("ok")

    cfg = make_config(
        "basic",
        data_path=os.path.join(root, "data", "EventVolume250000"),
        bbox_path=os.path.join(root, "labels"),
        batch_size=args.batch,
        num_workers=4,
        max_epoch=args.epochs,
        max_epoch_to_stop=args.epochs,
        warmup_epochs=1,
        augmentation=not args.no_augment,
        half_precision=False,
        event_volume_bins=5,
        img_size_override=INPUT_HW,
        sensor_hw_override=SENSOR_HW,
        log_path=os.path.join(args.out, "log") + "/",
        exp_name="learnability",
    )
    # init_lr = base_lr_per_64/64*batch (linear law); retarget via base
    cfg.base_lr_per_64 = args.lr * 64.0 / args.batch
    t = Trainer(cfg, device=dev)
    t.create_datasets()
    t.build(len(t.train_loader))

    best = {"map": -1.0, "ap50": -1.0, "epoch": -1}
    final_stats = None
    for epoch in range(args.epochs):
        losses = t.train_epoch()
        # streams*windows < batch -> zero train steps -> empty losses dict
        loss = losses.get("total_loss", float("nan"))
        if (epoch + 1) % args.eval_every and epoch != args.epochs - 1:
            print(f"# epoch {epoch}: loss {loss:.3f}", file=sys.stderr)
            continue
        ev = t.make_evaluator()
        ev.filter_boxes = _no_filter
        stats = t.eval_epoch(ev)
        print(f"# epoch {epoch}: loss {loss:.3f} "
              f"mAP {stats[0]:.3f} AP50 {stats[1]:.3f}", file=sys.stderr)
        final_stats = stats
        if stats[0] > best["map"]:
            best = {"map": float(stats[0]), "ap50": float(stats[1]),
                    "epoch": epoch}
    result = {"metric": "synthetic_learnability_ap50",
              "value": round(best["ap50"], 4),
              "map": round(best["map"], 4),
              "best_epoch": best["epoch"],
              "streams": args.streams, "epochs": args.epochs}

    if args.int8_eval:
        # PTQ accuracy gate on the TRAINED weights (the final epoch's, the
        # EMA's when kept): calibrate on two val batches as the eval step
        # preprocesses them, quantize those weights, re-run the COCO eval
        xs = []
        for i, (imgs, _, _, _) in enumerate(t.val_loader):
            x = imgs.to(dev)
            if cfg.half_precision:
                x = x.to(torch.bfloat16)
            if cfg.patchified:
                x = space_to_depth_patches(x)
            xs.append(x)
            if i >= 1:
                break
        with t._eval_weights():
            t.model.eval()
            scales = calibrate_int8(t.model, xs)
            table = build_weight_table(t.model.state_dict(), scales)
        print(f"# int8 eval: {len(scales)} conv sites quantized",
              file=sys.stderr)
        t.eval_step = make_eval_step(cfg.strides,
                                     half_precision=cfg.half_precision,
                                     patchify=cfg.patchified,
                                     quant=(scales, table), device=dev)
        ev = t.make_evaluator()
        ev.filter_boxes = _no_filter
        stats8 = t.eval_epoch(ev)
        print(f"# int8 eval: mAP {stats8[0]:.3f} AP50 {stats8[1]:.3f}",
              file=sys.stderr)
        # the f32 number from the SAME (final-epoch) weights, so the int8
        # delta is like for like even when an earlier epoch was "best"
        result["map_f32_final"] = round(float(final_stats[0]), 4)
        result["ap50_f32_final"] = round(float(final_stats[1]), 4)
        result["map_int8"] = round(float(stats8[0]), 4)
        result["ap50_int8"] = round(float(stats8[1]), 4)

    print(json.dumps(result))
    return result


def main(argv=None):
    return learnability(parse_args(argv))


if __name__ == "__main__":
    main()
