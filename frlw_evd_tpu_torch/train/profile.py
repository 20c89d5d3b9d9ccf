"""Where a train step's time goes on the card, summarised.

    python -m frlw_evd_tpu_torch.train.profile gen1_train [--steps 5]
    python -m frlw_evd_tpu_torch.train.profile recconv [--steps 5]

A TRAIN_CONFIGS key profiles `run_train` (the AED, stem bfm, full width,
Adam 1e-3, bf16 compute over f32 masters, dropout on). An exp type of
FAMILIES profiles its Trainer's train step (the config's model, widths and
batch of 64, bf16 over f32 masters, GEN1 geometry or the yolov3 config's
640x640) on device-resident synthetic_batches (16 channels; yolov3:
gt_creator's targets), the batches the Trainer's loader would bring left
out.

Prints the wall time per step without the profiler and under it (for an
exp type also the first step's, one-off costs included), the time per
step in which a kernel ran and its share of the unprofiled wall (the rest
is the card idle, waiting on the host), and the 30 operators whose own
kernels take the most device time, per step.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..utils.profiling import device_busy_us
from .config import make_config
from .synthetic import TRAIN_CONFIGS, run_train, synthetic_batches

WARMUP = 3
ROWS = 30
FAMILIES = ("yolov3_taf_bfm", "red", "convlstm", "recconv")


def profile_family(exp_type: str, steps: int) -> dict:
    """WARMUP + `steps` train steps of exp_type's Trainer on the card, then
    `steps` more under torch.profiler: run_train's keys for the printout."""
    from .trainer import Trainer
    from ..models.yolov3 import gt_creator

    cfg = make_config(exp_type, dataset="gen1", event_volume_bins=8)
    batch = cfg.batch_size
    trainer = Trainer(cfg, device="cuda")
    trainer.build(1)
    dev = trainer.device
    data = []
    for imgs, labels in synthetic_batches(np.random.default_rng(0), 2, batch,
                                          cfg.img_size, cfg.num_classes):
        if cfg.family == "yolov3":
            labels = gt_creator(cfg.img_size[0], cfg.strides, labels)
        data.append((torch.from_numpy(imgs).to(dev),
                     torch.from_numpy(labels).to(dev)))

    def run(n):
        t0 = time.perf_counter()
        for i in range(n):
            losses = trainer.train_step(trainer.state, *data[i % 2],
                                        trainer.generator)
        float(losses["total_loss"])
        return (time.perf_counter() - t0) / n * 1e3

    first = run(1)
    run(WARMUP - 1)
    wall = run(steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = run(steps)
    return {"profile": prof, "ms_per_step": wall, "first_ms": first,
            "profiled_ms_per_step": profiled,
            "busy_ms_per_step": device_busy_us(prof.events()) / 1e3 / steps,
            "batch": batch, "device": torch.cuda.get_device_name(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", choices=sorted(TRAIN_CONFIGS) + list(FAMILIES))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    if args.config in TRAIN_CONFIGS:
        rep = run_train(args.config, steps=args.steps, warmup=WARMUP,
                        profile=True)
    else:
        rep = profile_family(args.config, args.steps)
    wall, busy = rep["ms_per_step"], rep["busy_ms_per_step"]
    print(f"{args.config} on {rep['device']}: batch {rep['batch']}, "
          f"{args.steps} steps after {WARMUP}: wall {wall:.2f} ms/step "
          f"({rep['profiled_ms_per_step']:.2f} under the profiler), kernels "
          f"busy {busy:.2f} ms/step = {busy / wall:.1%} of the unprofiled "
          f"wall, idle {1 - busy / wall:.1%}"
          + (f"; the first step {rep['first_ms']:.2f} ms"
             if "first_ms" in rep else ""))
    ops = [e for e in rep["profile"].key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("operators by the device time of their own kernels, per step:")
    for e in ops[:ROWS]:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:9.3f} ms "
              f"{e.count / args.steps:7.1f} calls  {e.key}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
