"""Data-parallel cases held to the one-process run (parallel/dist.py,
multihost.py, the group BatchNorm and the train steps of train/trainer.py).

Each case computes on this rank's rows of a seeded global batch and
returns its outputs on the host. Run in one process (no group) it gives
the one-process reference on the whole batch; run on each rank of a
group, its outputs are compared with that reference (the tests hold them
on the CPU over gloo, chip_smoke.py phase 42 on the card):

    objects  gather_objects of per-rank payloads, sync_batch_stats of a
             module's and of a state_dict's BatchNorm statistics;
    bn       the group BatchNorm in f64: y, mean, var, the gradients of
             (y * g).sum() for x and the affine (the latter this rank's
             share), and a BatchNorm2d's running statistics after one f32
             training forward;
    dropout  a Dropout(0.3) output: the rows of the one-process output;
    aed      one SGD(1e-2) step of the narrow AED (32 wide, stem bfm,
             dropout 0) on small_batch(64x96), in f32 and in f64: the
             losses, running statistics, parameter sums after and (f64)
             the gradients; --aed_state loads its weights from a
             state_dict;
    yolov3   the same for YOLOv3Detector (Darknet-53, 64x64, gt_creator's
             targets), in f64 only (Darknet-53's steps are the case's
             cost; the AED and red hold the f32 group BatchNorm);
    red      the same for REDDetector (64x96, batch 2, fresh carries);
    trainer  one Trainer.train() epoch of taf_bfm with the narrow AED
             (dropout 0.1, f32, no augmentation) over the blob tree that
             --trainer (a JSON dict: data_path, bbox_path, log_path,
             sensor_hw, input_hw) names: each step's losses, the
             validation's COCO stats, the checkpoint files rank 0 wrote,
             the state after;
    cli      cli.train.main on --cli's arguments under the group: the
             last validation's COCO stats, the checkpoint files, every
             kernel wrapper's launches;
    gen1     one Adam (1e-3) step of gen1_train's full-width AED (256
             wide, 2 classes, batch 64 at 256x320, dropout 0, TF32 off)
             in f32 and in f64: losses, running statistics, parameters
             after, gradients.

    python -m frlw_evd_tpu_torch.parallel.check --out DIR [--device cpu]
        [--backend gloo] [--cases aed,red] [--aed_state FILE]

runs under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT; `spawn` sets it for n local processes) and
writes DIR/rank<r>.pt, {case: outputs}. Also --time_gen1 N: gen1_train
through train.run_train (bf16 over f32 masters) for N timed steps under
the group, its ms/step and windows/s under "time_gen1".
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shlex
import socket
import subprocess
import sys

import numpy as np
import torch
from torch import nn

from . import dist
from .multihost import gather_objects, sync_batch_stats

CASES = ("objects", "bn", "dropout", "aed", "yolov3", "red")
LR = 1e-2
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)


def small_batch(rng, H=64, W=96, N=4, channels=16):
    """N volumes U(0, 1) of (H, W, channels) and (N, 10, 5) label rows
    [class, cx, cy, w, h], 3 gts a volume of 2 classes (chip_smoke.py's
    small_train_batch)."""
    imgs = rng.uniform(0, 1, (N, H, W, channels)).astype(np.float32)
    labels = np.zeros((N, 10, 5), np.float32)
    for b in range(N):
        labels[b, :3] = [[rng.integers(0, 2), rng.uniform(20, W - 20),
                          rng.uniform(20, H - 20), rng.uniform(8, 30),
                          rng.uniform(8, 30)] for _ in range(3)]
    return imgs, labels


def _host(t):
    return t.detach().cpu()


def case_objects(dev):
    r = dist.rank()
    gathered = gather_objects({"rank": r, "dets": [("box", i * 1.5)
                                                   for i in range(3 + 5 * r)]})
    bn = nn.BatchNorm2d(4).to(dev)
    bn.running_mean.fill_(float(r))
    bn.running_var.fill_(1.0 + r)
    sd = {"bn.running_mean": torch.full((3,), 2.0 * r, device=dev),
          "bn.running_var": torch.full((3,), 4.0 + r, device=dev),
          "conv.weight": torch.full((3,), float(r), device=dev)}
    sync_batch_stats(bn)
    sync_batch_stats(sd)
    return {"gathered": gathered,
            "module": {k: _host(v) for k, v in bn.state_dict().items()},
            "state_dict": {k: _host(v) for k, v in sd.items()}}


def case_bn(dev):
    from ..models.blocks import BatchNorm2d, batch_norm_train

    g = torch.Generator().manual_seed(0)
    x = (torch.randn(8, 6, 5, 7, generator=g, dtype=torch.float64) * 3 + 2)
    y_grad = torch.randn(8, 6, 5, 7, generator=g, dtype=torch.float64)
    w = torch.rand(6, generator=g, dtype=torch.float64) + 0.5
    b = torch.randn(6, generator=g, dtype=torch.float64)
    x, y_grad = dist.shard_batch((x, y_grad))
    x = x.to(dev).requires_grad_()
    w, b = w.to(dev).requires_grad_(), b.to(dev).requires_grad_()
    y, mean, var = batch_norm_train(x, w, b, 1e-5)
    (y * y_grad.to(dev)).sum().backward()
    bn = BatchNorm2d(6).to(dev).train()
    bn(x.detach().float())
    return {"y": _host(y), "mean": _host(mean), "var": _host(var),
            "x_grad": _host(x.grad), "w_grad": _host(w.grad),
            "b_grad": _host(b.grad),
            "running": {k: _host(v) for k, v in bn.state_dict().items()
                        if k.startswith("running")}}


def case_dropout(dev):
    from ..models.blocks import Dropout

    drop = Dropout(0.3).train()
    drop.generator = torch.Generator(device=dev).manual_seed(5)
    x = dist.shard_batch(torch.arange(8 * 4 * 6 * 6, dtype=torch.float32)
                         .view(8, 4, 6, 6) + 1.0)
    return {"out": _host(drop(x.to(dev))), "out2": _host(drop(x.to(dev)))}


def _no_dropout_(model):
    from ..models.blocks import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return model


def _sgd_step(model, make_step, dtype, imgs, targets, dev):
    """One SGD(LR) step of a copy of `model` in `dtype` on this rank's rows:
    the losses, the running statistics after, each parameter's sum after
    (f64) and, in f64, the gradients (stored f32: each within 6e-8 of
    itself, far inside a gate of 1e-6 of its leaf's largest)."""
    from ..train import TrainState, sgd

    model = copy.deepcopy(model).to(dev, dtype).train()
    state = TrainState(0, model, sgd(LR).make(model.named_parameters()))
    imgs, targets = dist.shard_batch((imgs, targets))
    losses = make_step(dev)(state, torch.from_numpy(imgs).to(dtype),
                            torch.from_numpy(targets),
                            torch.Generator(device=dev))
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "stats": {k: _host(v).double()
                     for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))},
           "param_sums": {k: float(p.detach().double().sum())
                          for k, p in model.named_parameters()}}
    if dtype == torch.float64:
        out["grads"] = {k: _host(p.grad).float()
                        for k, p in model.named_parameters()}
    return out


_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _steps(model, make_step, imgs, targets, dev, runs=("f32", "f64")):
    return {run: _sgd_step(model, make_step, _DTYPES[run], imgs, targets,
                           dev) for run in runs}


def case_aed(dev, aed_state=None):
    from ..models import build_detector
    from ..train import make_train_step

    model = _no_dropout_(build_detector(
        2, stem="bfm", train=True, dropout_rate=0.0,
        generator=torch.Generator().manual_seed(0), **NARROW))
    if aed_state:
        model.load_state_dict(torch.load(aed_state, weights_only=True))
    imgs, labels = small_batch(np.random.default_rng(0))
    return _steps(model, lambda d: make_train_step(
        (8, 16, 32), 2, 2.5, device=d), imgs, labels, dev)


def case_yolov3(dev):
    from ..models.detector import init_parameters_
    from ..models.yolov3 import YOLOv3Detector, gt_creator
    from ..train import make_yolov3_train_step

    model = YOLOv3Detector(2, 16, dropout_rate=0.0)
    init_parameters_(model, torch.Generator().manual_seed(0))
    imgs, labels = small_batch(np.random.default_rng(1), 64, 64)
    targets = gt_creator(64, (8, 16, 32), labels)
    return _steps(model, lambda d: make_yolov3_train_step(
        2, 64, device=d), imgs, targets, dev, runs=("f64",))


def case_red(dev):
    from ..models import red
    from ..models.detector import init_parameters_
    from ..train import make_red_train_step

    model = red.REDDetector(2, 16)
    init_parameters_(model, torch.Generator().manual_seed(0))
    imgs, labels = small_batch(np.random.default_rng(2), N=2)
    priors = red.build_priors(64, 96)
    return _steps(model, lambda d: make_red_train_step(
        64, 96, priors, device=d), imgs, labels, dev)


def _gen1_step(dev, dtype):
    """One Adam (1e-3) step of gen1_train's full-width AED in `dtype`,
    dropout 0, on this rank's rows of the seeded batch of 64: losses,
    running statistics and parameters after, gradients."""
    from ..models import build_detector
    from ..train import TrainState, adam, make_train_step
    from ..train.synthetic import LR as ADAM_LR, RADIUS, synthetic_batches

    model = _no_dropout_(build_detector(
        2, stem="bfm", train=True,
        generator=torch.Generator().manual_seed(0))).to(dev, dtype)
    state = TrainState(0, model, adam(ADAM_LR).make(model.named_parameters()))
    [(imgs, labels)] = synthetic_batches(np.random.default_rng(0), 1, 64,
                                         (256, 320), 2)
    imgs, labels = dist.shard_batch((imgs, labels))
    losses = make_train_step((8, 16, 32), 2, RADIUS, device=dev)(
        state, torch.from_numpy(imgs).to(dtype), torch.from_numpy(labels),
        torch.Generator(device=dev))
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "grads": {k: _host(p.grad).double()
                     for k, p in model.named_parameters()},
           "state": {k: _host(v).double()
                     for k, v in model.state_dict().items()
                     if v.is_floating_point()}}
    del model, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def case_gen1(dev):
    """gen1_train's full-width AED (256 wide, 2 classes, batch 64 at
    256x320), one Adam step in f32 (TF32 off) and one in f64: the f32
    step's losses and statistics, the f64 step's gradients and
    parameters (Adam's first update, lr * g / (|g| + eps), moves an
    element whose f32 gradient is at its rounding noise by +-lr)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return {name: _gen1_step(dev, dtype)
                for name, dtype in (("f32", torch.float32),
                                    ("f64", torch.float64))}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def case_trainer(dev, trainer=None):
    from ..models import build_detector
    from ..train import Trainer, make_config

    kw = json.loads(trainer)
    cfg = make_config(
        "taf_bfm", dataset="gen1", batch_size=2, num_workers=1,
        event_volume_bins=8, augmentation=False, half_precision=False,
        img_size_override=tuple(kw["input_hw"]),
        sensor_hw_override=tuple(kw["sensor_hw"]),
        data_path=kw["data_path"], bbox_path=kw["bbox_path"],
        log_path=kw["log_path"], exp_name="dp", max_epoch_to_stop=1)
    t = Trainer(cfg, device=dev)
    t._make_tb_writer = lambda: None      # TensorBoard loads TensorFlow
    t.model = build_detector(2, stem="bfm", train=True, dropout_rate=0.1,
                             generator=torch.Generator().manual_seed(0),
                             **NARROW)
    t.train()
    return {"losses": t.history[0]["losses"],
            "stats": list(t.last_eval["stats"]),
            "files": sorted(os.listdir(t.ckpt_dir)),
            "state": {k: _host(v).double()
                      for k, v in t.model.state_dict().items()
                      if v.is_floating_point()}}


def kernel_counters() -> dict:
    """{name: wrapper} of every kernel wrapper that counts its launches."""
    from .. import encode
    from ..models import quantize, stem_chain

    names = ("scatter_cnt_tsum", "scatter_cnt_tsum_pallas_sorted",
             "scatter_cnt_tsum_pallas", "taf_update_leaky",
             "taf_update_leaky_raw", "taf_update_leaky_v2")
    return {**{n: getattr(encode, n) for n in names},
            "bfm_chain_apply_folded": stem_chain.bfm_chain_apply_folded,
            "bfm_chain_apply": stem_chain.bfm_chain_apply,
            "int8_conv2d": quantize.int8_conv2d}


def case_cli(dev, cli=None):
    from ..cli import train as cli_train

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t = cli_train.main(shlex.split(cli) + ["--device", dev.type])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"stats": list(t.last_eval["stats"]) if t.last_eval else None,
            "files": sorted(os.listdir(t.ckpt_dir)),
            "history": [{k: h[k] for k in ("epoch", "steps", "wall_s",
                                           "loader_wait_s", "losses")}
                        for h in t.history],
            "launches": {k: fn.launches for k, fn in counters.items()}}


def run_case(name: str, dev, **kw):
    fn = {"objects": case_objects, "bn": case_bn, "dropout": case_dropout,
          "aed": case_aed, "yolov3": case_yolov3, "red": case_red,
          "trainer": case_trainer, "cli": case_cli,
          "gen1": case_gen1}[name]
    return fn(torch.device(dev), **kw)


def time_gen1(steps: int, dev) -> dict:
    """gen1_train through train.run_train (bf16 over f32 masters, dropout
    on) under the group: ms/step, windows/s, peak bytes, the losses."""
    from ..train import run_train

    out = run_train("gen1_train", steps=steps, warmup=2, device=dev)
    return {k: out[k] for k in ("ms_per_step", "windows_per_s",
                                "peak_bytes", "losses", "batch")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--aed_state", default=None)
    ap.add_argument("--trainer", default=None,
                    help="the trainer case's tree, a JSON dict")
    ap.add_argument("--cli", default=None,
                    help="the cli case's cli.train arguments, one string")
    ap.add_argument("--time_gen1", type=int, default=0)
    args = ap.parse_args(argv)
    dev = dist.init_process_group(args.device, backend=args.backend)
    try:
        cases = [c for c in args.cases.split(",") if c]
        extra = {"aed": {"aed_state": args.aed_state},
                 "trainer": {"trainer": args.trainer},
                 "cli": {"cli": args.cli}}
        out = {c: run_case(c, dev, **extra.get(c, {})) for c in cases}
        if args.time_gen1:
            out["time_gen1"] = time_gen1(args.time_gen1, dev)
        out["world"] = dist.world()
        os.makedirs(args.out, exist_ok=True)
        torch.save(out, os.path.join(args.out, f"rank{dist.rank()}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(n: int, argv, *, module: str = "frlw_evd_tpu_torch.parallel.check",
          local_rank_zero: bool = False, env: dict | None = None):
    """Start `python -m module *argv` as n local processes in torchrun's
    environment (ranks 0..n-1, a free localhost port; LOCAL_RANK the rank,
    or 0 for every rank with local_rank_zero: n ranks on one card, which
    gloo takes and NCCL refuses); `wait` for them."""
    port = str(free_port())
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for r in range(n):
        penv = {**os.environ, **(env or {}), "RANK": str(r),
                "WORLD_SIZE": str(n),
                "LOCAL_RANK": "0" if local_rank_zero else str(r),
                "LOCAL_WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
                "MASTER_PORT": port,
                "PYTHONPATH": os.pathsep.join(
                    [root, os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait(procs, timeout: float = 600.0) -> list[str]:
    """The processes' outputs; raises if one fails or outlives `timeout`
    (every process is ended either way)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


def spawn(n: int, argv, *, timeout: float = 600.0, **kw) -> list[str]:
    """`start`, then `wait`."""
    return wait(start(n, argv, **kw), timeout)


if __name__ == "__main__":
    sys.exit(main())
