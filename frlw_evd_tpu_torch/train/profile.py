"""Where a train step's time goes on the card: `run_train` with its
profile option (the AED, stem bfm, full width, Adam 1e-3, bf16 compute
over f32 masters, dropout on), summarised.

    python -m frlw_evd_tpu_torch.train.profile gen1_train [--steps 5]

Prints the wall time per step without the profiler and under it, the time
per step in which a kernel ran and its share of the unprofiled wall (the
rest is the card idle, waiting on the host), and the 30 operators whose
own kernels take the most device time, per step.
"""

from __future__ import annotations

import argparse

import torch
from torch.autograd import DeviceType

from .synthetic import TRAIN_CONFIGS, run_train

WARMUP = 3
ROWS = 30


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", choices=sorted(TRAIN_CONFIGS))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    rep = run_train(args.config, steps=args.steps, warmup=WARMUP,
                    profile=True)
    wall, busy = rep["ms_per_step"], rep["busy_ms_per_step"]
    print(f"{args.config} on {rep['device']}: batch {rep['batch']}, "
          f"{args.steps} steps after {WARMUP}: wall {wall:.2f} ms/step "
          f"({rep['profiled_ms_per_step']:.2f} under the profiler), kernels "
          f"busy {busy:.2f} ms/step = {busy / wall:.1%} of the unprofiled "
          f"wall, idle {1 - busy / wall:.1%}")
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
