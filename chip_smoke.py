#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; no phase catches and continues):
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel of the serving path from frlw_evd_tpu_torch/csrc with nvcc for
     sm_90a, all sources compiled in parallel;
  2. kernel B1 (scatter_cnt_tsum) against its plain twin at the full GEN1
     shape (B = 128 streams, E = 16384 event slots), uniform and skewed
     events with bursty n_valid: counts exact, t-sums within the f32
     reordering bound cnt^2 * 2^-23 (the kernel's atomics add in a
     run-dependent order);
  3. kernel B2 (taf_update_leaky) against its twin at full shape with one
     frozen stream: state exact (the same f32 operations), volume within
     one bf16 ulp (2^-8, where log1pf rounds differently);
  4. the main path at full width: AED (BFM stem, Darknet-21, PAFPN, YOLOX
     head, 256 wide, 2 classes) in bf16, B = 128, 256x320 input, seeded
     random weights whose obj biases are raised, 4 windows carrying state;
     both kernels' launch counts must rise and every output be finite;
     then per-stage times (CUDA events, after warm-up) and windows/s;
  5. the slice on a small input against the same slice on the CPU (plain
     twins), f32 without TF32: states, volumes and keep masks agree.
It prints one {"kernels": [...]} JSON line and the nvidia-smi line before
its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

GEN1_SENSOR, GEN1_INPUT = (240, 304), (256, 320)
B, E, K = 128, 16384, 8
MAIN_WINDOWS = 4
# HBM rate of the part nvidia-smi names (NVIDIA data sheets); the bound of
# a kernel is the bytes it must move over this rate
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def hbm_rate(name: str) -> float:
    for part, rate in HBM_BYTES_PER_S.items():
        if part in name:
            return rate
    raise SystemExit(f"no memory rate on record for card {name!r}")


def time_ms(fn, n: int = 10, warm: int = 2) -> float:
    """Mean ms per call on the card: CUDA events around n calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_scatter(enc, ev_sets, dev, rate):
    """Phase 2: B1 vs its twin; times on the uniform set."""
    H, W = GEN1_SENSOR
    err = 0.0
    for name, (ev, nv) in ev_sets.items():
        cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, height=H, width=W)
        p_cnt, p_tsum, p_any = enc.scatter_cnt_tsum_plain(ev, nv, height=H,
                                                          width=W)
        torch.cuda.synchronize()
        if not torch.equal(cnt, p_cnt) or not torch.equal(anyv, p_any):
            raise SystemExit(f"B1 {name}: counts differ from the twin")
        diff = (tsum - p_tsum).abs()
        if not bool((diff <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()):
            raise SystemExit(f"B1 {name}: t-sum error {diff.max().item()} "
                             f"beyond the reordering bound")
        err = max(err, diff.max().item())
        log(f"B1 {name}: counts exact ({int(p_cnt.sum().item())} events), "
            f"max |dtsum| {diff.max().item():.3e}")
    ev, nv = ev_sets["uniform"]
    P = H * W * 2
    ms = time_ms(lambda: enc.scatter_cnt_tsum(ev, nv, height=H, width=W))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_plain(ev, nv, height=H,
                                                          width=W))
    # library yardstick: one index_add_ of the [1, t - 1] columns
    from frlw_evd_tpu_torch.encode.scatter import event_cells
    idx, tv, valid = event_cells(ev, nv, H, W)
    offs = torch.arange(B, device=dev)[:, None] * P
    flat = torch.where(valid, idx + offs, B * P).reshape(-1)
    vals = torch.stack([valid.float(), tv * valid], -1).reshape(-1, 2)
    target = torch.zeros(B * P + 1, 2, device=dev)

    def library():
        target.zero_()
        target.index_add_(0, flat, vals)
    library_ms = time_ms(library)
    n_events = int(nv.sum().item())
    bytes_moved = B * 4 + n_events * 16 + 2 * B * P * 4 + B * 4
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bytes_moved / rate * 1e3)


def check_update(enc, ev_sets, dev, rate):
    """Phase 3: B2 vs its twin at full shape, stream 3 frozen."""
    H, W = GEN1_SENSOR
    ev, nv = ev_sets["skewed"]
    nv = nv.clone()
    nv[3] = 0
    cnt, tsum, anyv = enc.scatter_cnt_tsum_plain(ev, nv, height=H, width=W)
    g = torch.Generator(device=dev).manual_seed(0)
    state = -30.0 * torch.rand(B, H, W * 2 * K, device=dev, generator=g)
    state[:, :, ::5] = -6000.0
    twin_state = state.clone()
    frozen = state[3].clone()
    _, vol = enc.taf_update_leaky(state, cnt, tsum, anyv, height=H, width=W)
    _, p_vol = enc.taf_update_leaky_plain(twin_state, cnt, tsum, anyv,
                                          height=H, width=W)
    torch.cuda.synchronize()
    st_err = (state - twin_state).abs().max().item()
    vol_err = (vol.float() - p_vol.float()).abs().max().item()
    if st_err != 0.0 or vol_err > 2.0 ** -8 or not torch.equal(state[3],
                                                               frozen):
        raise SystemExit(f"B2: state err {st_err}, vol err {vol_err}, "
                         f"frozen stream kept: {torch.equal(state[3], frozen)}")
    log(f"B2: state exact, max |dvol| {vol_err:.3e}, frozen stream unchanged")
    ms = time_ms(lambda: enc.taf_update_leaky(state, cnt, tsum, anyv,
                                              height=H, width=W))
    plain_ms = time_ms(lambda: enc.taf_update_leaky_plain(
        twin_state, cnt, tsum, anyv, height=H, width=W))
    N = B * H * W * 2 * K
    P = H * W * 2
    bytes_moved = N * 4 * 2 + N * 2 + 2 * B * P * 4 + B * 4
    return dict(max_abs_err=max(st_err, vol_err), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bytes_moved / rate * 1e3)


def run_main_path(pipeline, enc, windows, dev, card):
    """Phase 4: the serving path at full width; returns launch counts."""
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(2, stem="bfm",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    run = pipeline.make_pipeline_kernel(model, GEN1_SENSOR, GEN1_INPUT,
                                        device=dev, dtype=torch.bfloat16)
    state = pipeline.new_state(B, GEN1_SENSOR, device=dev)

    enc.scatter_cnt_tsum.launches = 0
    enc.taf_update_leaky.launches = 0
    for i, (ev, nv) in enumerate(windows):
        state, vol = run.stages["encode_transform"](state, ev, nv)
        dets, keep = run.stages["detect"](vol)
        torch.cuda.synchronize()
        if not (torch.isfinite(state).all() and torch.isfinite(vol).all()
                and torch.isfinite(dets).all()):
            raise SystemExit(f"main path window {i}: non-finite output")
        if vol.shape != (B, *GEN1_INPUT, 2 * K) or dets.shape != (B, 100, 6):
            raise SystemExit(f"main path window {i}: shapes {vol.shape}, "
                             f"{dets.shape}")
        n_valid_rows = int((dets[..., 5] > 0).sum().item())
        log(f"main path window {i}: kept {int(keep.sum().item())} of "
            f"{n_valid_rows} boxes past conf 0.3 over {B} streams")
    launches = {"scatter_cnt_tsum": enc.scatter_cnt_tsum.launches,
                "taf_update_leaky": enc.taf_update_leaky.launches}
    if min(launches.values()) < len(windows):
        raise SystemExit(f"main path did not go through the kernels: "
                         f"{launches}")

    ev, nv = windows[0]
    enc_ms = time_ms(lambda: run.stages["encode_transform"](state, ev, nv))
    _, vol = run.stages["encode_transform"](state, ev, nv)
    det_ms = time_ms(lambda: run.stages["detect"](vol), n=5)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        ev, nv = windows[i % len(windows)]
        state, _ = run(state, ev, nv)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    log(f"main path on {card}: encode_transform {enc_ms:.3f} ms, detect "
        f"{det_ms:.3f} ms per {B}-stream window batch; run_step "
        f"{step_s * 1e3:.3f} ms = {B / step_s:.1f} windows/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def check_small_against_cpu(pipeline, dev):
    """Phase 5: the slice on the card vs on the CPU, 60x72 → 64x96, f32."""
    from frlw_evd_tpu_torch.models import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sensor, inp = (60, 72), (64, 96)
    runs, states = {}, {}
    for d in ("cpu", dev):
        model = build_detector(2, stem="bfm", in_channels=(32, 32, 32),
                               stem_out_channels=16, head_width=32)
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        runs[d] = pipeline.make_pipeline_kernel(model, sensor, inp, device=d,
                                                dtype=torch.float32)
        states[d] = pipeline.new_state(2, sensor, device=d)
    ev, nv = pipeline.synth_events(np.random.default_rng(7), 3, 2, 1024,
                                   sensor)
    for i in range(3):
        out = {}
        for d, run in runs.items():
            states[d], vol = run.stages["encode_transform"](
                states[d], torch.from_numpy(ev[i]).to(d),
                torch.from_numpy(nv[i]).to(d))
            out[d] = (vol, *run.stages["detect"](vol))
        (c_vol, _, c_keep), (g_vol, g_dets, g_keep) = out["cpu"], out[dev]
        st_err = (states[dev].cpu() - states["cpu"]).abs().max().item()
        vol_err = (g_vol.cpu().float() - c_vol.float()).abs().max().item()
        same_keep = torch.equal(g_keep.cpu(), c_keep)
        if (st_err > 1e-2 or vol_err > 2e-2 or not same_keep
                or not torch.isfinite(g_dets).all()):
            raise SystemExit(f"small input window {i}: state err {st_err}, "
                             f"vol err {vol_err}, keep masks equal: "
                             f"{same_keep}, dets finite: "
                             f"{bool(torch.isfinite(g_dets).all())}")
        log(f"small input window {i}: card vs CPU state err {st_err:.2e}, "
            f"vol err {vol_err:.2e}, keep masks equal "
            f"({int(c_keep.sum())} kept)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from frlw_evd_tpu_torch import encode as enc
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(0)
    ev_u, nv_u = pipeline.synth_events(rng, 2, B, E, GEN1_SENSOR)
    ev_s, nv_s = pipeline.synth_events_skewed(rng, 2, B, E, GEN1_SENSOR)
    windows = [(torch.from_numpy(ev[i]).to(dev),
                torch.from_numpy(nv[i]).to(dev))
               for ev, nv in ((ev_u, nv_u), (ev_s, nv_s)) for i in range(2)]
    ev_sets = {"uniform": windows[0], "skewed": windows[2]}

    rows = {"scatter_cnt_tsum": check_scatter(enc, ev_sets, dev, rate),
            "taf_update_leaky": check_update(enc, ev_sets, dev, rate)}
    launches = run_main_path(pipeline, enc, windows[:MAIN_WINDOWS], dev, card)
    check_small_against_cpu(pipeline, dev)

    meta = {
        "scatter_cnt_tsum": ("frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                             "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "taf_update_leaky": ("frlw_evd_tpu_torch/csrc/taf_update.cu",
                             "frlw_evd_tpu/encode/pallas_update.py:37"),
    }
    kernels = []
    for kname, row in rows.items():
        source, replaces = meta[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": "bytes",
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
