"""Training CLI (counterpart of the repository's train.py; reference
train.py). The same flags, so recipes carry over, --patchified and
--remat included, less the JAX-only --rng_impl, plus --device (default
cuda, which raises without a card) and --img_size / --sensor_hw for a
geometry other than the dataset's (ExpConfig's overrides; the synthetic
trees of data/synthetic):

    python -m frlw_evd_tpu_torch.cli.train --exp_type taf_bfm \\
        --dataset gen1 --batch_size 64 --data_path <blob dir> \\
        --bbox_path <label dir> [--resume_exp NAME] [--device cpu]

Data-parallel over N cards (NCCL; gloo with --device cpu), --batch_size
the global batch, a multiple of N:

    python -m torch.distributed.run --nproc_per_node=N \\
        -m frlw_evd_tpu_torch.cli.train ... (the same flags)

Under torchrun's environment (WORLD_SIZE set) the process joins the group
first (parallel/dist.py); rank 0 logs to stdout and to
<log_path>/<exp>/file_<stamp>_train_log.txt.
"""

from __future__ import annotations

import argparse
import os

from ..parallel import dist
from ..train import Trainer, make_config
from ..utils.logger import setup_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train an event detector")
    parser.add_argument("--exp_type", type=str, default="basic")
    parser.add_argument("--dataset", type=str, default="gen1")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_cpu_workers", type=int, default=4)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--bbox_path", type=str, required=True)
    parser.add_argument("--log_path", type=str, default="log/")
    parser.add_argument("--event_volume_bins", type=int, default=5)
    parser.add_argument("--resume_exp", type=str, default=None)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--augmentation", type=lambda s: s != "False",
                        default=True)
    parser.add_argument("--nodes", type=int, default=1,
                        help="accepted for recipe compatibility; the "
                             "process count is torchrun's")
    parser.add_argument("--max_epoch_to_stop", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dist_backend", type=str, default=None,
                        help="under torchrun: nccl (the default on cuda) or "
                             "gloo (the CPU, or ranks sharing one card)")
    parser.add_argument("--img_size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="network input (blob) size, for a geometry "
                             "other than the dataset's")
    parser.add_argument("--sensor_hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="sensor size the labels are in, with "
                             "--img_size")
    parser.add_argument("--patchified", action="store_true",
                        help="train / eval through the quarter-resolution "
                             "p64 stem (the same parameters and math)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward in the backward, as "
                             "the JAX trainer does; one checkpoint around "
                             "the whole forward saves no peak memory here "
                             "(gen1_train on an H100: 0.97x the peak at "
                             "1.4-1.8x the ms/step, chip_smoke.py phase "
                             "33)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = make_config(
        args.exp_type,
        dataset=args.dataset,
        batch_size=args.batch_size,
        num_workers=args.num_cpu_workers,
        data_path=args.data_path,
        bbox_path=args.bbox_path,
        log_path=args.log_path,
        event_volume_bins=args.event_volume_bins,
        resume_exp=args.resume_exp,
        exp_name=args.exp_name,
        augmentation=args.augmentation,
        seed=args.seed,
        img_size_override=tuple(args.img_size) if args.img_size else None,
        sensor_hw_override=(tuple(args.sensor_hw) if args.sensor_hw
                            else None),
        patchified=args.patchified,
        remat=args.remat,
    )
    if args.max_epoch_to_stop is not None:
        cfg.max_epoch_to_stop = args.max_epoch_to_stop
    device = args.device
    owns_group = "WORLD_SIZE" in os.environ and not dist.initialized()
    if "WORLD_SIZE" in os.environ:
        device = dist.init_process_group(device, backend=args.dist_backend)
    try:
        trainer = Trainer(cfg, device=device)
        # the run's log file beside its checkpoints, in the directory the
        # Trainer made
        exp_dir = os.path.join(cfg.log_path,
                               cfg.exp_name or cfg.resume_exp or cfg.exp_type)
        logger = setup_logger(exp_dir if os.path.isdir(exp_dir) else None,
                              dist.rank(), "train_log.txt")
        logger.info(f"{cfg.exp_type} on {dist.world()} x {device}, global "
                    f"batch {cfg.batch_size}")
        trainer.train()
        logger.info("done")
    finally:
        if owns_group:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
