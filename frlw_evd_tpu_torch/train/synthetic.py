"""The SimOTA train step on synthetic volumes (counterpart of bench.py's
run_train_bench and its gen1_train / gen4_train configs,
bench.py:101-106, :460-564).

`run_train` builds the AED (Darknet-21, YOLOPAFPN, YOLOXHead, 256 wide,
stem `bfm`) with seeded random weights, Adam at 1e-3, centre radius 2.5
and bf16 compute over f32 masters, with the stem's dropout active; makes
the bench's synthetic batches with numpy; runs warm-up steps, the first
under a FLOP counter, then timed steps ending in a host read, and on the
card, when asked, as many steps again under torch.profiler.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.detector import EventDetector, build_detector
from ..pipeline import K, STRIDES, resolve_device
from ..utils.profiling import device_busy_us, flops_report
from .trainer import adam, create_train_state, make_train_step

TRAIN_CONFIGS = {
    "gen1_train": dict(input_hw=(256, 320), batch=64, num_classes=2),
    "gen4_train": dict(input_hw=(512, 640), batch=32, num_classes=7),
}
N_LABELS = 40
STEPS_PER_CALL = 10    # distinct batches the bench cycles over, at most
RADIUS = 2.5
LR = 1e-3


def synthetic_batches(rng: np.random.Generator, n_inputs: int, batch: int,
                      input_hw, num_classes: int,
                      events_kind: str = "uniform"):
    """n_inputs (volume, labels) pairs as bench.py:513-539 makes them:
    volumes (batch, h, w, 2K) f32, U(0, 1) everywhere ("uniform") or six
    U(0, 1) blobs of half-size 8 to 63 a sample on zeros ("skewed");
    labels (batch, 40, 5) with 3 to 19 valid rows [class, cx, cy, w, h]."""
    if events_kind not in ("uniform", "skewed"):
        raise ValueError(f"events_kind must be 'uniform' or 'skewed', got "
                         f"{events_kind!r}")
    h, w = input_hw
    out = []
    for _ in range(n_inputs):
        if events_kind == "skewed":
            vol = np.zeros((batch, h, w, 2 * K), np.float32)
            for b in range(batch):
                for _ in range(6):
                    cy, cx = rng.integers(0, h), rng.integers(0, w)
                    sz = int(rng.integers(8, 64))
                    y0, x0 = max(0, cy - sz), max(0, cx - sz)
                    region = vol[b, y0:cy + sz, x0:cx + sz]
                    region[:] = rng.uniform(0, 1, region.shape)
        else:
            vol = rng.uniform(0, 1, (batch, h, w, 2 * K)).astype(np.float32)
        labels = np.zeros((batch, N_LABELS, 5), np.float32)
        n_gt = rng.integers(3, N_LABELS // 2, batch)
        for b in range(batch):
            g = int(n_gt[b])
            labels[b, :g, 0] = rng.integers(0, num_classes, g)
            labels[b, :g, 1] = rng.uniform(20, w - 20, g)
            labels[b, :g, 2] = rng.uniform(20, h - 20, g)
            labels[b, :g, 3] = rng.uniform(8, 80, g)
            labels[b, :g, 4] = rng.uniform(8, 60, g)
        out.append((vol, labels))
    return out


def device_batches(cfg: dict, dev, *, seed: int = 0,
                   events_kind: str = "uniform"):
    """The bench's distinct batches of `cfg` on `dev`, as (volume, labels)
    tensor pairs: the volumes stored bf16 when the bench's ten f32 batches
    would pass 4 GB (bench.py:502-504), else f32; as many batches as fit
    in about 2 GB, 2 to STEPS_PER_CALL (bench.py:511-512)."""
    batch, hw, nc = cfg["batch"], cfg["input_hw"], cfg["num_classes"]
    vol_bytes = batch * hw[0] * hw[1] * 2 * K * 4
    store = (torch.bfloat16 if STEPS_PER_CALL * vol_bytes > 4e9
             else torch.float32)
    n_inputs = max(2, min(STEPS_PER_CALL,
                          int(2e9 // (vol_bytes * store.itemsize // 4))))
    return [(torch.from_numpy(v).to(dev, store), torch.from_numpy(l).to(dev))
            for v, l in synthetic_batches(np.random.default_rng(seed),
                                          n_inputs, batch, hw, nc,
                                          events_kind)]


def run_train(config, *, steps: int = 10, warmup: int = 2,
              events_kind: str = "uniform", seed: int = 0,
              model: EventDetector | None = None, device="cuda",
              profile: bool = False) -> dict:
    """`warmup` + `steps` train steps of `config`: a TRAIN_CONFIGS key, or
    a dict with the same keys (input_hw, batch, num_classes).

    model: the AED to train, built here (stem bfm, 256 wide, weights from
    torch seed `seed`) when None. The batches are `device_batches`'.
    Returns {"state", "losses": [per-step dict of floats], "ms_per_step",
    "windows_per_s", "flops_per_step" (the first warm-up step, counted as
    utils/profiling.py says), "peak_bytes" (max_memory_allocated over the
    timed steps on the card, else None), "batch", "device"}; the times are
    on the host clock, from the first timed step to a host read of the
    last step's loss.

    profile (card only): after the timed steps, `steps` more under
    torch.profiler, adding "profile" (the profiler, for its
    key_averages()), "profiled_ms_per_step" (their wall, on the host clock
    as above) and "busy_ms_per_step" (the time a step in which a kernel
    ran, utils.profiling.device_busy_us); their losses are not kept."""
    if warmup < 1 or steps < 1:
        raise ValueError(f"run_train needs warmup >= 1 and steps >= 1, got "
                         f"{warmup}, {steps}")
    cfg = TRAIN_CONFIGS[config] if isinstance(config, str) else config
    dev = resolve_device(device)
    if profile and dev.type != "cuda":
        raise ValueError("run_train profiles the card's kernels only")
    batch, nc = cfg["batch"], cfg["num_classes"]
    if model is None:
        model = build_detector(nc, stem="bfm", train=True,
                               generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, adam(LR), device=dev)
    step = make_train_step(STRIDES, nc, RADIUS, half_precision=True,
                           device=dev)

    data = device_batches(cfg, dev, seed=seed, events_kind=events_kind)
    n_inputs = len(data)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)

    losses = []
    counted = flops_report(step, state, *data[0], generator)
    losses.append(counted["result"])
    for i in range(1, warmup):
        losses.append(step(state, *data[i % n_inputs], generator))
    float(losses[-1]["total_loss"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        losses.append(step(state, *data[i % n_inputs], generator))
    float(losses[-1]["total_loss"])
    elapsed = time.perf_counter() - t0
    traced = {}
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(warmup + steps, warmup + 2 * steps):
                last = step(state, *data[i % n_inputs], generator)
            float(last["total_loss"])
            traced_s = time.perf_counter() - t0
        traced = {"profile": prof,
                  "profiled_ms_per_step": traced_s / steps * 1e3,
                  "busy_ms_per_step": device_busy_us(prof.events()) / 1e3
                  / steps}
    return {
        **traced,
        "state": state,
        "losses": [{k: float(v) for k, v in step_losses.items()}
                   for step_losses in losses],
        "ms_per_step": elapsed / steps * 1e3,
        "windows_per_s": batch * steps / elapsed,
        "flops_per_step": counted["flops"],
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "batch": batch,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
