"""Export the serving step to a self-contained torch.export program
(counterpart of tools/export_model.py, which writes a StableHLO blob).

The exported step is the JAX contract: an f32 (B, H, W, C) volume in,
cast to bf16 inside; the detector; eval_decode in f32; postprocess_batch
with 100 detections; (dets (B, 100, 6) [cx, cy, w, h, cls, score], keep
(B, 100) bool) out, the parameters baked in. `torch.export.save` writes
the `.pt2`, beside a `.meta.json` with JAX's fields. `--check` loads the
program with `torch.export.load` and holds it to the live model on one
random volume: keep equal, dets within atol 1e-5.

    python -m frlw_evd_tpu_torch.tools.export_model --out model.pt2 \\
        [--exp_type taf_bfm --dataset gen1 --batch 1] [--ckpt FILE] \\
        [--fuse] [--int8 [--calib vols.npy]] [--check] [--device cpu]

Loading (the package registers the int8 operator the program calls):

    import torch, frlw_evd_tpu_torch
    dets, keep = torch.export.load("model.pt2").module()(vol)

The same flags as JAX's tool; --platform is --device here (default
cuda, which raises without a card). With no --ckpt the weights are seeded
random (torch seed 0); --ckpt takes a port checkpoint (train/
checkpoints.py). --fuse folds every BatchNorm into its conv first
(models/fuse.py). --int8 calibrates the sites on two batches of 4
uniform volumes from numpy seed 7 (or the first 16 of --calib's (N, H, W,
C) volumes, 4 a batch), quantizes them from the f32 (folded) weights and
serves each as an Int8Conv, which calls frlw_evd_torch::int8_conv2d: the
hand-written int8 conv on the card, its twin on the CPU. The fixpoint NMS
of the live step ends its loop when no flag changes; the exported step
runs its K rounds (postprocess nms_impl "rounds": the same boxes, no
data-dependent control flow). The kernel stems (bfm_folded,
bfm_p64_kernel) launch through ctypes and are refused.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

from ..models import build_detector
from ..models.detector import eval_decode
from ..models.fuse import fuse_conv_bn_params
from ..models.postprocess import postprocess_batch
from ..models.quantize import (build_weight_table, calibrate_int8,
                               int8_modules_)
from ..pipeline import _serving_model
from ..train import make_config

MAX_DETECTIONS = 100
KERNEL_STEMS = ("bfm_folded", "bfm_p64_kernel")


class ServingStep(nn.Module):
    """vol (B, H, W, C) f32 -> (dets, keep): the volume cast to bf16 (the
    JAX contract) and on to the model's dtype, the model, the head maps'
    f32 eval_decode, postprocess_batch(max_detections=100, nms_impl)."""

    def __init__(self, model: nn.Module, strides, nms_impl: str):
        super().__init__()
        self.model = model
        self.strides = tuple(strides)
        self.nms_impl = nms_impl
        self.dtype = next(model.parameters()).dtype

    def forward(self, vol):
        outs = self.model(vol.to(torch.bfloat16).to(self.dtype))
        decoded = eval_decode([o.float() for o in outs], self.strides)
        return postprocess_batch(decoded, max_detections=MAX_DETECTIONS,
                                 nms_impl=self.nms_impl)


def config(exp_type="taf_bfm", dataset="gen1", event_volume_bins=8,
           img_hw=None, small=False, width=0):
    """The exp type's config with the tool's size overrides (JAX's
    --img_hw, --small, --width)."""
    cfg = make_config(exp_type, dataset=dataset,
                      event_volume_bins=event_volume_bins,
                      augmentation=False)
    if img_hw:
        cfg.img_size_override = tuple(img_hw)
    if small:
        cfg.in_channels = (32, 32, 32)
    if width:
        cfg.in_channels = (width,) * 3
    return cfg


def build_model(cfg, ckpt=None) -> nn.Module:
    """cfg's detector in f32 at eval: seeded weights, or a checkpoint's.
    Refuses the kernel stems, whose ctypes launches a trace cannot see."""
    if cfg.stem in KERNEL_STEMS:
        raise ValueError(f"stem {cfg.stem!r} runs a ctypes kernel that "
                         f"torch.export cannot trace; export the 'bfm' "
                         f"form of the same checkpoint")
    model = build_detector(
        cfg.num_classes, family=cfg.family, stem=cfg.stem, act=cfg.act,
        strides=cfg.strides, in_channels=cfg.in_channels, depth=cfg.depth,
        input_channels=cfg.input_channels,
        generator=torch.Generator().manual_seed(0))
    if ckpt:
        model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                         weights_only=True)["model"])
    return model.eval()


def calibration_batches(cfg, calib=None):
    """Two batches of 4 uniform [0, 1) volumes from numpy seed 7, or the
    first 16 volumes of the .npy `calib`, 4 a batch (JAX's tool)."""
    h, w = cfg.img_size
    shape = (h, w, cfg.input_channels)
    if calib:
        vols = np.load(calib)
        if vols.ndim != 4 or vols.shape[1:] != shape:
            raise ValueError(f"--calib holds {vols.shape}, wants (N, "
                             f"{h}, {w}, {cfg.input_channels})")
        return [vols[i:i + 4].astype(np.float32)
                for i in range(0, min(len(vols), 16), 4)]
    rng = np.random.default_rng(7)
    return [rng.uniform(0, 1, (4, *shape)).astype(np.float32)
            for _ in range(2)]


def build_serving_fn(cfg, model: nn.Module, batch: int, *, device="cuda",
                     dtype=torch.bfloat16, fuse: bool = False,
                     int8: bool = False, calib=None,
                     nms_impl: str = "fixpoint"):
    """(ServingStep, input shape, int8 sites): `model` folded when `fuse`,
    cast IN PLACE to `dtype` on `device` (pipeline._serving_model), and
    with `int8` its sites calibrated and replaced by Int8Conv modules."""
    if fuse:
        model.load_state_dict(fuse_conv_bn_params(model.state_dict()))
    f32_state = {k: v.detach().float().clone()
                 for k, v in model.state_dict().items()}
    dev = _serving_model(model, device, dtype)
    n_sites = 0
    if int8:
        batches = [torch.from_numpy(b).to(dev, torch.bfloat16).to(dtype)
                   for b in calibration_batches(cfg, calib)]
        scales = calibrate_int8(model, batches)
        n_sites = int8_modules_(model, scales,
                                build_weight_table(f32_state, scales))
    h, w = cfg.img_size
    return (ServingStep(model, cfg.strides, nms_impl),
            (batch, h, w, cfg.input_channels), n_sites)


def export(step: ServingStep, shape, device) -> torch.export.ExportedProgram:
    """torch.export of `step` with its K-round NMS on an f32 volume of
    `shape` on `device`."""
    rounds = ServingStep(step.model, step.strides, "rounds")
    example = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(rounds, (example,))
    # torch.export.save would write the example volume too (671 MB at
    # GEN1, B = 128)
    program.example_inputs = None
    return program


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--exp_type", default="taf_bfm")
    ap.add_argument("--dataset", default="gen1")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--event_volume_bins", type=int, default=8)
    ap.add_argument("--ckpt", default=None,
                    help="a port checkpoint; seeded weights if omitted")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", action="store_true",
                    help="load the program and compare it with the live "
                         "model on a random volume")
    ap.add_argument("--fuse", action="store_true",
                    help="fold BatchNorm into the convs first")
    ap.add_argument("--int8", action="store_true",
                    help="int8 sites through the hand-written int8 conv")
    ap.add_argument("--calib", default=None,
                    help=".npy of (N, H, W, C) calibration volumes")
    ap.add_argument("--img_hw", type=int, nargs=2, default=None)
    ap.add_argument("--small", action="store_true",
                    help="32-wide trunk and neck (smoke)")
    ap.add_argument("--width", type=int, default=0,
                    help="trunk and neck width (smoke; >= 64 keeps the "
                         "int8 sites)")
    args = ap.parse_args(argv)

    cfg = config(args.exp_type, args.dataset, args.event_volume_bins,
                 args.img_hw, args.small, args.width)
    step, shape, n_sites = build_serving_fn(
        cfg, build_model(cfg, args.ckpt), args.batch, device=args.device,
        fuse=args.fuse, int8=args.int8, calib=args.calib)
    if args.int8:
        print(f"int8: {n_sites} conv sites quantized "
              f"({'real' if args.calib else 'synthetic'} calibration)")
    dev = next(step.parameters()).device
    program = export(step, shape, dev)
    torch.export.save(program, args.out)
    meta = {
        "input": {"shape": list(shape), "dtype": "float32",
                  "layout": "NHWC volume (leaky TAF / encoder output)"},
        "outputs": {"dets": "(B, 100, 6) [cx, cy, w, h, cls, score]",
                    "keep": "(B, 100) bool"},
        "exp_type": args.exp_type, "dataset": args.dataset,
        "precision": ("int8-ptq ({} calibration)".format(
            "real" if args.calib else "synthetic") if args.int8 else "bf16"),
        "fused": args.fuse, "int8_sites": n_sites,
        "device": str(dev), "torch": torch.__version__,
        "load": "import frlw_evd_tpu_torch; torch.export.load(path)",
    }
    with open(args.out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported {os.path.getsize(args.out) / 1e6:.2f} MB -> "
          f"{args.out} ({dev})")

    if args.check:
        rng = np.random.default_rng(0)
        vol = torch.from_numpy(rng.uniform(0, 1, shape).astype(
            np.float32)).to(dev)
        with torch.no_grad():
            live_dets, live_keep = step(vol)
            got_dets, got_keep = torch.export.load(args.out).module()(vol)
        if not torch.equal(live_keep, got_keep):
            raise SystemExit("roundtrip check failed: keep differs")
        err = (live_dets - got_dets).abs().max().item()
        if not err <= 1e-5:
            raise SystemExit(f"roundtrip check failed: dets {err}")
        print(f"roundtrip check ok: loaded program matches live model "
              f"(dets max |d| {err}, {int(live_keep.sum())} kept)")
    return program


if __name__ == "__main__":
    main()
