"""Evaluation CLI (counterpart of the repository's test.py; reference
test.py), plus --device (default cuda, which raises without a card) and
the geometry overrides of cli.train (--img_size, --sensor_hw):

    python -m frlw_evd_tpu_torch.cli.test --exp_type taf_bfm \\
        --dataset gen1 --batch_size 1 --data_path <blob dir> \\
        --bbox_path <label dir> --resume_exp NAME [--record True]

Prints `COCO stats: (...)`, the six stats of the test split under the
experiment's best_epoch checkpoint.
"""

from __future__ import annotations

import argparse

from ..train import Trainer, make_config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate an event detector")
    parser.add_argument("--exp_type", type=str, default="basic")
    parser.add_argument("--dataset", type=str, default="gen1")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_cpu_workers", type=int, default=4)
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--bbox_path", type=str, required=True)
    parser.add_argument("--log_path", type=str, default="log/")
    parser.add_argument("--event_volume_bins", type=int, default=5)
    parser.add_argument("--resume_exp", type=str, default=None)
    parser.add_argument("--record", type=lambda s: s == "True", default=False)
    parser.add_argument("--nodes", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--img_size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="network input (blob) size, for a geometry "
                             "other than the dataset's")
    parser.add_argument("--sensor_hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="sensor size the labels are in, with "
                             "--img_size")
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
        record=args.record,
        augmentation=False,
        img_size_override=tuple(args.img_size) if args.img_size else None,
        sensor_hw_override=(tuple(args.sensor_hw) if args.sensor_hw
                            else None),
    )
    trainer = Trainer(cfg, device=args.device)
    stats = trainer.test()
    print("COCO stats:", stats)
    return stats


if __name__ == "__main__":
    main()
