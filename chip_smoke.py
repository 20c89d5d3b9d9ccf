#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; no phase catches and continues):
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel from frlw_evd_tpu_torch/csrc with nvcc for sm_90a, all
     sources compiled in parallel;
  2. kernel B1 (scatter_cnt_tsum) against its plain twin at the full GEN1
     shape (B = 128 streams, E = 16384 event slots), uniform and skewed
     events with bursty n_valid and a one-cell set (every event of a stream
     in one pixel and polarity): counts and any_ev exact, t-sums within
     cnt^2 * 2^-23 of the twin's (B1's contract allows any order of adds;
     the kernel sums exactly), every output cell written (the outputs land in
     blocks poisoned with NaN); the cluster tiling printed; times on each
     set beside index_add_, of the per-block-tile form, and the split of
     the uniform time (no slot counted, slots read but none counted, the
     planes' writes alone);
  3. kernel B2 (taf_update_leaky) against its twin at full shape with one
     frozen stream: state exact (the same f32 operations), volume within
     one bf16 ulp (2^-8, where log1pf rounds differently);
  4. the GEN1 main path at full width: AED (BFM stem, Darknet-21, PAFPN,
     YOLOX head, 256 wide, 2 classes) in bf16, B = 128, 256x320 input,
     seeded random weights whose obj biases are raised, 4 windows carrying
     state; its kernels' launch counts must rise and every output be
     finite; then per-stage times (CUDA events, after warm-up), windows/s;
  5. that slice on a small input against the same slice on the CPU (plain
     twins), f32 without TF32: states, volumes and keep masks agree;
  6. B1 in the p64 cell order against its twin at the full gen4 shape
     (B = 128, E = 65536, 512x640), uniform, skewed and one-cell, as in
     phase 2;
  7. kernel B3 (taf_update_leaky_raw) against its twin at full gen4 shape
     with one frozen stream: state exact, volume within one bf16 ulp;
  8. kernels B4 (bfm_chain_apply_folded) and B7 (bfm_chain_apply) against
     their twins on all 128 streams of the gen4 volume: atol 1e-2 + rtol
     1e-2 (a bf16-rounded intermediate may round the other way), B4's pad
     channels exactly zero; the share of outputs that differ from the twin
     at all, the weight pack's time beside the wrapper's, and the SASS of
     libbfm_chain.so: it must hold HMMA (tensor-core) instructions and no
     local-memory spills (STL / LDL);
  9. the 1 Mpx (gen4_taf) main path at full width: AED with the bfm_folded
     stem, 7 classes, bf16, B = 128, E = 65536, 512x640, 4 windows carrying
     state; B1, B3 and B4 must launch on every window; per-stage times,
     windows/s and peak memory;
 10. the bfm_p64_kernel stem (fold_output=False, chain in B7) at full gen4
     shape for 3 windows: B7 must launch;
 11. the 1 Mpx slice on a small input against the same slice on the CPU,
     f32 without TF32 (see check_small_p64_against_cpu for the gates);
 12. kernel B6 (scatter_cnt_tsum_pallas_sorted) against its twin at the
     full gen4 shape on the p64 cells of the uniform and skewed windows and
     of a one-cell set: counts exact, t-sums bitwise equal to the twin's,
     two launches bitwise equal, every output cell written (poisoned
     blocks); the cluster tiling printed; times on each set beside
     index_add_, of the per-block-tile form, and phase 2's split;
 13. kernel B5 (taf_update_leaky_v2) against its twin at full gen4 shape
     with one frozen stream (state exact, volume within one bf16 ulp), and
     against B3 on the same B1 planes, bit for bit;
 14. kernel B8 (scatter_cnt_tsum_pallas) on its own path, the folded cells
     of the GEN1 uniform and skewed windows, then against its twin on
     those, a one-cell set and the uniform set with t scaled by 1e6:
     counts exact, t-sums within cnt^2 * 2^-23 (times max|t| of the
     scaled set), every output cell written (poisoned blocks); the cluster
     tiling and the atomic instructions of its SASS printed; timed beside
     B1 and index_add_, and under two other tilings (per-block tiles, two
     clusters of 8 a stream);
 15. the 1 Mpx path through the new entries at full width: make_pipeline_p64
     (scatter="sorted") with the bfm_folded AED for 3 windows carrying
     state, then taf_stream_step_kernel_p64(precise=True) feeding the same
     detect stage for 3 windows; B5 and B4 must launch on every window of
     both, B6 on every window of the second; per-stage times, windows/s;
 16. the precise and sorted p64 steps and the precise GEN1 step on a small
     input, card against CPU, with phase 11's state and volume gates;
 17. gen1_train at full width: the AED SimOTA train step (stem bfm,
     Darknet-21, PAFPN, YOLOX head, 256 wide, 2 classes, 256x320x16 input,
     batch 64, Adam 1e-3, radius 2.5, bf16 compute over f32 masters,
     dropout on) through frlw_evd_tpu_torch.train.run_train: 2 warm-up
     steps (the first under FlopCounterMode), then 10 timed steps ending in
     a host read; ms/step, windows/s, peak memory and MFU over the dense
     bf16 peak; every loss finite, total_loss moving, every master f32 and
     moved, every BatchNorm statistic moved, and no kernel launched;
 18. gen4_train the same: 7 classes, 512x640x16 input, batch 32;
 19. one train step of a small AED, card against CPU (TF32 off, dropout
     0): in f32 the losses within rtol 2e-4 and the running statistics
     within atol 1e-5, and with the network in f64 the gradients within
     1e-6 of each leaf's largest magnitude and the parameters after the SGD
     step within atol 1e-6, the gates of tests/test_torch_port_train.py;
 20. B1 and B6 at E = 2^19 slots a stream (the JAX fetcher's padding) on 4
     streams at the gen4 sensor, uniform and one-cell: one launch a chunk
     of at most 2^17 - 1 slots, then B1 against its twin with phase 2's
     gates and B6 bit for bit with its twin; each timed;
 21. the int8 conv kernel (int8_conv2d: wgmma s8, TMA-fed weights) against
     its twin at every distinct int8 site shape of the GEN1 AED and of the
     gen4 AED (stem bfm_folded, 7 classes, 512x640) at B = 128 (k, stride,
     Cin, Cout, H x W): int32 sums equal and bf16 outputs equal bit for
     bit, both from int8_conv2d and from an Int8Site (the path's launch,
     with its weight map encoded once); each site's device time (the
     Int8Site's, time_ms) beside its bound (the larger of its bytes over the HBM rate and
     2 * MACs over the dense int8 tensor-core rate), its tile plan, the
     host microseconds a launch takes, torch._int_mm on the same codes (1x1
     sites: the same int32 function) and cuDNN's bf16 conv of the site (a
     yardstick, not the same function); per-window sums for both models;
     the host cost of encoding a weight map; the SASS of libint8_conv.so
     must hold IGMMA and no STL / LDL;
 22. the GEN1 int8 serving path at full width (phase 4's AED with its
     BatchNorm scales from U(1, 1.75), int8_gen1_model says why; bf16,
     calibrated on the live encode output by pipeline.calibrate_pipeline
     as bench.py --dtype int8 does): 6 windows carrying state, int8_conv2d
     launched (sites) x (windows) times and B1, B2 on every window,
     outputs finite; every site within relative L2 0.04 of its bf16 conv
     on the same input and the head maps within 0.08 of the bf16 maps per
     level (tests/test_quantize.py's gates); encode_transform, detect and
     windows/s of the int8 and the bf16 path in turns;
 23. the gen4 int8 serving path the same way (make_pipeline_p64(quant=...),
     stem bfm_folded, 7 classes, 512x640, B = 128, the BatchNorm scales of
     phase 22): calibrated, then 3 windows carrying state; int8_conv2d
     launched (sites) x (windows) times and B1, B3, B4 on every window;
     phase 22's gates and timing in turns;
 24. the TAF steps at full width, 3 windows each carrying state: at GEN1
     the unpacked step (mxu: B6; sorted; exact) and the packed step
     (pallas: B1; pallas precise: B6; sorted; mxu: B6; xla); at gen4 the
     packed step (pallas: B1; sorted), the folded step (pallas: B1 → B2;
     sorted → B2) and the p64 step at
     K = 4 (raw: B1 → B2; precise: B6 → B2; sorted → B2); first B6 at the
     GEN1 cells, B1 in the gen4 folded order and B2 at the gen4 folded
     and the p64 K = 4 geometries against their twins (B6 and B2's state
     bit for bit); each volume within two bf16 ulps of
     taf_stream_step_kernel's (the K = 4 one of the four newest bins of
     taf_stream_step_kernel_p64's); device ms a window;
 25. the serving configs gen1_taf_dense, gen1_taf_p64, gen1_taf_packed,
     gen4_taf_packed and gen4_taf_xla (bench.py:59-99) at their shapes and
     widths through make_pipeline / make_pipeline_packed, 4 windows
     carrying state: outputs finite, B6 (dense, p64) or B1 (packed) on
     every window; per-stage ms, windows/s, peak memory;
 26. the streaming encoder configs gen1_eci, gen1_sae, gen1_sae_max,
     gen1_ev and gen1_frame (bench.py:128-145) through
     make_encoder_step: both signatures warmed, five runs of 50 windows
     each ending in a host read; windows/s, Mev/s and ms a window of the
     median run with the runs' spread (host clock), device ms a window;
     sae sorted and max within rtol 1e-3, atol 1e-2;
 27. every function of phases 24-26 and the offline encoders on a small
     input, card against CPU, at the CPU tests' tolerances.
Every phase that drives a path sets all launch counts to 0 just before it
and reads them just after, and each phase prints its wall seconds. It
prints one {"kernels": [...]} JSON line, one entry per kernel and B1 once
per cell order, each entry's launches and times from one path (every path
that launches it under launches_by_path), and the nvidia-smi line before
its last line, {"ok": true, "device": {...}}. Every ms it prints is the
device's time (time_ms: CUDA events around calls queued behind a sleep);
windows/s and ms/step are on the host clock.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

GEN1_SENSOR, GEN1_INPUT = (240, 304), (256, 320)
GEN4_SENSOR = (512, 640)               # gen4_taf: input == sensor
B, E, E4, K = 128, 16384, 65536, 8
# one image of each model's detector input: GEN1 (H, W, 2K), gen4 the
# folded p64 volume (H/2, (W/2) * 64)
GEN1_VOLUME = (*GEN1_INPUT, 2 * K)
GEN4_VOLUME = (GEN4_SENSOR[0] // 2, GEN4_SENSOR[1] // 2 * 64)
MAIN_WINDOWS = 4
# HBM rate, f32 CUDA-core FMA rate and dense bf16 tensor-core rate (FLOP/s)
# of the part nvidia-smi names (NVIDIA data sheets); a kernel's bound is the
# largest of its bytes over the HBM rate and each type of its operations
# over the peak rate for that type
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
                   "H100": 3.35e12}
F32_FLOP_PER_S = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H200": 67e12,
                  "H100": 67e12}
BF16_TENSOR_FLOP_PER_S = {"H100 PCIe": 756e12, "H100 NVL": 835e12,
                          "H200": 989e12, "H100": 989e12}
# dense int8 tensor-core rate (OP/s), twice the bf16 rate on each part
INT8_TENSOR_OPS_PER_S = {k: 2 * v for k, v in BF16_TENSOR_FLOP_PER_S.items()}
INT8_WINDOWS = 6
GEN4_INT8_WINDOWS = 3
# exp2 and reciprocal run on the special function units: 16 results per
# clock per SM on compute capability 9.0 against 128 f32 FMAs (CUDA C++
# Programming Guide, arithmetic instruction throughput), so the SFU rate is
# the f32 FMA rate in FLOP/s over 16. silu(u) = u / (1 + exp(-u)) with IEEE
# expf and division, or as ex2.approx and rcp.approx (kernels B4 and B7),
# needs one of each, so 2 SFU results per silu at least.
SFU_PER_SILU = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def _rate(table, name: str) -> float:
    for part, rate in table.items():
        if part in name:
            return rate
    raise SystemExit(f"no rate on record for card {name!r}")


def hbm_rate(name: str) -> float:
    return _rate(HBM_BYTES_PER_S, name)


def f32_flops(name: str) -> float:
    return _rate(F32_FLOP_PER_S, name)


def bf16_tensor_flops(name: str) -> float:
    return _rate(BF16_TENSOR_FLOP_PER_S, name)


def device_windows(pipeline, rng, e_per_bin, sensor, dev):
    """Four windows on the card: two uniform, then two skewed."""
    ev_u, nv_u = pipeline.synth_events(rng, 2, B, e_per_bin, sensor)
    ev_s, nv_s = pipeline.synth_events_skewed(rng, 2, B, e_per_bin, sensor)
    return [(torch.from_numpy(ev[i]).to(dev), torch.from_numpy(nv[i]).to(dev))
            for ev, nv in ((ev_u, nv_u), (ev_s, nv_s)) for i in range(2)]


def time_ms(fn, n: int = 10, warm: int = 2) -> float:
    """Mean ms per call on the card: CUDA events around n calls, queued
    behind a sleep of ~10 ms on the card, so that the calls are enqueued
    before the first runs and the events time the device alone, not the
    host's launch cost (a call that syncs the host drains the queue, and
    is timed with its host gaps). Every ms of a kernel, its twin and its
    library call is timed so; windows/s are on the host clock."""
    for _ in range(warm):
        fn()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase(n: int, name: str, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"phase {n} ({name}): {time.perf_counter() - t0:.1f} s")
    return out


def index_add_ms(idx, tv, valid, size):
    """The library yardstick of the histograms: one index_add_ of the
    [1, t] columns of the counted slots into a (B * size + 1, 2) target."""
    B = idx.shape[0]
    offs = torch.arange(B, device=idx.device)[:, None] * size
    flat = torch.where(valid, idx + offs, B * size).reshape(-1)
    vals = torch.stack([valid.float(), tv * valid], -1).reshape(-1, 2)
    target = torch.zeros(B * size + 1, 2, device=idx.device)

    def library():
        target.zero_()
        target.index_add_(0, flat, vals)
    return time_ms(library)


def poison(*shapes):
    """Fill blocks of the given (shape, dtype) sizes with NaN (-7 for
    int32) and free them, so that the caching allocator hands them to the
    next call's outputs: a cell the kernel leaves unwritten then shows.
    Returns their addresses."""
    blocks = [torch.full(shape, float("nan") if dtype == torch.float32
                         else -7, dtype=dtype, device="cuda")
              for shape, dtype in shapes]
    torch.cuda.synchronize()
    return {t.data_ptr() for t in blocks}


def check_poisoned(name, outs, poisoned):
    """The outputs took the poisoned blocks and hold no NaN."""
    if not {t.data_ptr() for t in outs} <= poisoned:
        raise SystemExit(f"{name}: the outputs did not take the poisoned "
                         f"blocks, so the check would prove nothing")
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        raise SystemExit(f"{name}: an output cell was left unwritten (NaN)")


def plane_write_ms(B, P):
    """The two (B, P) f32 planes written once with fill_: the store floor
    of a histogram kernel on this card."""
    cnt = torch.empty(B, P, device="cuda")
    tsum = torch.empty_like(cnt)
    return time_ms(lambda: (cnt.fill_(1.0), tsum.fill_(1.0)))


def split_line(name, split, ms):
    return (f"{name} split on the uniform set: no slot counted and none read "
            f"{split['empty']:.3f} ms, every slot read and none counted "
            f"{split['scan']:.3f} ms, all {ms:.3f} ms; the two planes' "
            f"fill_ alone {split['planes']:.3f} ms")


def one_cell_events(ev):
    """Every event of each stream in one pixel and polarity."""
    one = ev.clone()
    one[..., 0], one[..., 1], one[..., 3] = 7.0, 5.0, 1.0
    return one


def check_scatter(enc, ev_sets, dev, rate, sensor, layout):
    """Phases 2 and 6: B1 vs its twin in one cell order on the uniform,
    skewed and one-cell sets, each call's outputs in blocks poisoned with
    NaN; times of B1 and index_add_ on each set, of the per-block-tile form
    (clusters of 1) on the uniform set."""
    H, W = sensor
    B = ev_sets["uniform"][0].shape[0]
    P = H * W * 2
    kw = dict(height=H, width=W, layout=layout)
    plan = enc.scatter.tile_plan(P)
    alone = enc.scatter.tile_plan(P, cluster=1)
    log(f"B1 {layout} launch: {plan.describe(P, B)}")
    log(f"B1 {layout} per-block tiles: {alone.describe(P, B)}")
    sets = dict(ev_sets, one_cell=(one_cell_events(ev_sets["uniform"][0]),
                                   ev_sets["uniform"][1]))
    err, ms, library_ms = 0.0, {}, {}
    for name, (ev, nv) in sets.items():
        poisoned = poison(((B, P), torch.float32), ((B, P), torch.float32),
                          ((B,), torch.int32))
        cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, **kw)
        torch.cuda.synchronize()
        check_poisoned(f"B1 {layout} {name}", (cnt, tsum, anyv), poisoned)
        p_cnt, p_tsum, p_any = enc.scatter_cnt_tsum_plain(ev, nv, **kw)
        torch.cuda.synchronize()
        if not torch.equal(cnt, p_cnt) or not torch.equal(anyv, p_any):
            raise SystemExit(f"B1 {layout} {name}: counts differ from the "
                             f"twin")
        diff = (tsum - p_tsum).abs()
        if not bool((diff <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()):
            raise SystemExit(f"B1 {layout} {name}: t-sum error "
                             f"{diff.max().item()} beyond the reordering bound")
        err = max(err, diff.max().item())
        log(f"B1 {layout} {name}: counts exact "
            f"({int(p_cnt.sum().item())} events), max |dtsum| "
            f"{diff.max().item():.3e} (t-sums bitwise equal to the twin's: "
            f"{torch.equal(tsum, p_tsum)}), every cell written")
        del cnt, tsum, p_cnt, p_tsum, diff
        ms[name] = time_ms(lambda: enc.scatter_cnt_tsum(ev, nv, **kw))
        library_ms[name] = index_add_ms(*enc.event_cells(ev, nv, H, W, layout),
                                        P)
    ev, nv = ev_sets["uniform"]
    alone_ms = time_ms(lambda: enc.scatter._event_histogram(
        ev, nv, H, W, layout, alone))
    off = ev.clone()
    off[..., 0] = -5.0                      # every event off the sensor
    none = torch.zeros_like(nv)
    split = dict(empty=time_ms(lambda: enc.scatter_cnt_tsum(ev, none, **kw)),
                 scan=time_ms(lambda: enc.scatter_cnt_tsum(off, nv, **kw)),
                 planes=plane_write_ms(B, P))
    log(split_line(f"B1 {layout}", split, ms["uniform"]))
    del off
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_plain(ev, nv, **kw))
    n_events = int(nv.sum().item())
    bytes_moved = B * 4 + n_events * 16 + 2 * B * P * 4 + B * 4
    bound_ms = bytes_moved / rate * 1e3
    log(f"B1 {layout}: " + ", ".join(
        f"{k} {ms[k]:.3f} ms (index_add_ {library_ms[k]:.3f})" for k in ms)
        + f"; per-block tiles {alone_ms:.3f} ms on uniform; twin "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=err, ms=ms["uniform"], plain_ms=plain_ms,
                library_ms=library_ms["uniform"], bound_ms=bound_ms,
                bound_by="bytes", ms_by_set=ms, library_ms_by_set=library_ms,
                per_block_tiles_ms=alone_ms, split_ms=split)


def b2_against_twin(enc, label, cnt, tsum, anyv, height, width, C, dev):
    """B2 vs its twin on a (B, height, width*C) queue of -30 * U(0, 1) with
    every fifth position -6000, stream 3 frozen (anyv[3] must be 0): state
    bit for bit, volume within one bf16 ulp (2^-8). Returns (state, twin
    state, volume error)."""
    g = torch.Generator(device=dev).manual_seed(0)
    state = -30.0 * torch.rand(B, height, width * C, device=dev, generator=g)
    state[:, :, ::5] = -6000.0
    twin_state = state.clone()
    frozen = state[3].clone()
    kw = dict(height=height, width=width)
    _, vol = enc.taf_update_leaky(state, cnt, tsum, anyv, **kw)
    _, p_vol = enc.taf_update_leaky_plain(twin_state, cnt, tsum, anyv, **kw)
    torch.cuda.synchronize()
    same = torch.equal(state, twin_state)
    vol_err = (vol.float() - p_vol.float()).abs().max().item()
    kept = torch.equal(state[3], frozen)
    if not same or vol_err > 2.0 ** -8 or not kept:
        raise SystemExit(f"B2 {label}: state bitwise equal to the twin's "
                         f"{same}, vol err {vol_err}, frozen stream kept: "
                         f"{kept}")
    log(f"B2 {label}: state bitwise equal to the twin's, max |dvol| "
        f"{vol_err:.3e}, frozen stream unchanged")
    return state, twin_state, vol_err


def check_update(enc, ev_sets, dev, rate):
    """Phase 3: B2 vs its twin at full shape, stream 3 frozen."""
    H, W = GEN1_SENSOR
    ev, nv = ev_sets["skewed"]
    nv = nv.clone()
    nv[3] = 0
    cnt, tsum, anyv = enc.scatter_cnt_tsum_plain(ev, nv, height=H, width=W)
    state, twin_state, vol_err = b2_against_twin(enc, "GEN1", cnt, tsum,
                                                 anyv, H, W, 2 * K, dev)
    ms = time_ms(lambda: enc.taf_update_leaky(state, cnt, tsum, anyv,
                                              height=H, width=W))
    plain_ms = time_ms(lambda: enc.taf_update_leaky_plain(
        twin_state, cnt, tsum, anyv, height=H, width=W))
    N = B * H * W * 2 * K
    P = H * W * 2
    bytes_moved = N * 4 * 2 + N * 2 + 2 * B * P * 4 + B * 4
    return dict(max_abs_err=vol_err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bytes_moved / rate * 1e3,
                bound_by="bytes")


def run_main_path(pipeline, counters, windows, dev, card):
    """Phase 4: the GEN1 serving path at full width; returns the launch
    counts of its run."""
    from frlw_evd_tpu_torch.models import build_detector

    model = gen1_model(build_detector, pipeline)
    run = pipeline.make_pipeline_kernel(model, GEN1_SENSOR, GEN1_INPUT,
                                        device=dev, dtype=torch.bfloat16)
    state = pipeline.new_state(B, GEN1_SENSOR, device=dev)

    for fn in counters.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches[k] for k in ("scatter_cnt_tsum",
                                 "taf_update_leaky")) < len(windows):
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


def check_update_raw(enc, ev_sets, dev, rate):
    """Phase 7: B3 vs its twin at full gen4 shape, stream 3 frozen."""
    H, W = GEN4_SENSOR
    ev, nv = ev_sets["skewed"]
    nv = nv.clone()
    nv[3] = 0
    cnt, tsum, anyv = enc.scatter_cnt_tsum_plain(ev, nv, height=H, width=W,
                                                 layout="p64")
    g = torch.Generator(device=dev).manual_seed(0)
    state = -30.0 * torch.rand(B, H // 2, W // 2 * 64, device=dev,
                               generator=g)
    state[:, :, ::5] = -6000.0
    twin_state = state.clone()
    frozen = state[3].clone()
    _, vol = enc.taf_update_leaky_raw(state, cnt, tsum, anyv, height=H,
                                      width=W)
    _, p_vol = enc.taf_update_leaky_raw_plain(twin_state, cnt, tsum, anyv,
                                              height=H, width=W)
    torch.cuda.synchronize()
    st_err = (state - twin_state).abs().max().item()
    vol_err = (vol.float() - p_vol.float()).abs().max().item()
    kept = torch.equal(state[3], frozen)
    if st_err != 0.0 or vol_err > 2.0 ** -8 or not kept:
        raise SystemExit(f"B3: state err {st_err}, vol err {vol_err}, "
                         f"frozen stream kept: {kept}")
    log(f"B3: state exact, max |dvol| {vol_err:.3e}, frozen stream unchanged")
    del vol, p_vol
    ms = time_ms(lambda: enc.taf_update_leaky_raw(state, cnt, tsum, anyv,
                                                  height=H, width=W))
    plain_ms = time_ms(lambda: enc.taf_update_leaky_raw_plain(
        twin_state, cnt, tsum, anyv, height=H, width=W), n=5)
    N = state.numel()
    bytes_moved = N * 4 * 2 + N * 2 + 2 * cnt.numel() * 4 + B * 4
    return dict(max_abs_err=max(st_err, vol_err), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bytes_moved / rate * 1e3,
                bound_by="bytes")


def sass(name: str) -> str:
    """The SASS of build/kernels/lib<name>.so, from cuobjdump."""
    from frlw_evd_tpu_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(_build.so_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def check_mma_sass(name: str, op: str):
    """The SASS of lib<name>.so must hold tensor-core `op` instructions
    (HMMA, IMMA) and no local-memory traffic (STL / LDL, which is how a
    register spill shows)."""
    text = sass(name)
    mma = len(re.findall(rf"\b{op}\b", text))
    local = len(re.findall(r"\b(?:STL|LDL)\b", text))
    log(f"lib{name}.so SASS: {mma} {op}, {local} STL/LDL instructions")
    if mma == 0 or local:
        raise SystemExit(f"{name}: {mma} {op} and {local} local-memory "
                         f"instructions in its SASS (want > 0 and 0)")


def check_chains(stem_chain, dev, card_name):
    """Phase 8: B4 and B7 vs their twins at full gen4 shape, bf16 volume,
    weights of a seeded full-width stem. Tolerance atol 1e-2 + rtol 1e-2:
    a bf16-rounded intermediate may round the other way where the twin
    sums in another order (and the kernels' silu is the SFU form); B4's
    pad channels exactly zero. Prints the share of outputs that differ from
    the twin at all, and the weight pack's time beside the wrapper's (which
    keeps its pack while the parameters are unchanged).

    Bound: the largest of the bytes over the HBM rate, the products
    (bf16 x bf16 with f32 sums, the tensor cores' type) over the bf16
    tensor-core rate, and silu's SFU results over the SFU rate, which no
    choice of unit for the products avoids."""
    from frlw_evd_tpu_torch.models.stems import BinsFusionModuleFolded

    H2, W2 = GEN4_SENSOR[0] // 2, GEN4_SENSOR[1] // 2
    stem = BinsFusionModuleFolded(2 * K, 64)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for pname, p in stem.chain_params().items():
            p.normal_(0.1 if pname.endswith("bias") else 0.0, 0.3,
                      generator=g)
    params = {k: v.detach().to(dev, torch.bfloat16)
              for k, v in stem.chain_params().items()}
    gd = torch.Generator(device=dev).manual_seed(1)
    vol = torch.rand(B, H2, W2 * 64, device=dev, generator=gd).to(
        torch.bfloat16)
    n_sub = B * H2 * W2 * 4
    products_s = (2 * stem_chain.MACS_PER_SUBPIXEL * n_sub
                  / bf16_tensor_flops(card_name))
    silu_s = (SFU_PER_SILU * stem_chain.SILU_PER_SUBPIXEL * n_sub
              / (f32_flops(card_name) / 16))
    check_mma_sass("bfm_chain", "HMMA")
    rows = {}
    for name, out_c in (("bfm_chain_apply_folded", 64),
                        ("bfm_chain_apply", 48)):
        fn = getattr(stem_chain, name)
        plain = getattr(stem_chain, name + "_plain")
        if name == "bfm_chain_apply_folded":
            args, kw = (vol, params), dict(width=W2)
        else:
            args, kw = (vol.view(B, H2, W2, 64), params), {}
        out = fn(*args, **kw).float()
        want = plain(*args, **kw).float()
        torch.cuda.synchronize()
        err = (out - want).abs()
        max_err = err.max().item()
        bad = int((err > 1e-2 + 1e-2 * want.abs()).sum().item())
        pad_zero = (out_c == 48
                    or not bool(out.view(B, H2, W2, 64)[..., 48:].any()))
        active = float((want > 0).float().mean().item())
        if bad or not pad_zero:
            raise SystemExit(f"{name}: {bad} values beyond atol 1e-2 + rtol "
                             f"1e-2 (max |d| {max_err}), pad zero: "
                             f"{pad_zero}")
        differ = float((out != want).float().mean().item())
        log(f"{name}: matches its twin on all {B} streams, max |d| "
            f"{max_err:.3e}, {differ:.4%} of outputs differ from the twin at "
            f"all, {active:.1%} of outputs > 0")
        del out, want, err
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fn(*args, **kw))
        pack_ms = time_ms(lambda: stem_chain._pack(
            stem_chain.chain_weights(params), dev))
        log(f"{name}: wrapper {ms:.3f} ms (weights packed once and kept); "
            f"the weight pack alone (chain_weights + _pack) {pack_ms:.3f} ms")
        plain_ms = time_ms(lambda: plain(*args, **kw), n=3, warm=1)
        bytes_s = ((vol.numel() * 2 + B * H2 * W2 * out_c * 2)
                   / hbm_rate(card_name))
        log(f"{name} bound parts: bytes {bytes_s * 1e3:.4f} ms, products on "
            f"bf16 tensor cores {products_s * 1e3:.4f} ms, silu on the SFUs "
            f"{silu_s * 1e3:.4f} ms")
        ops_s = max(products_s, silu_s)
        rows[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=max(bytes_s, ops_s) * 1e3,
                          bound_by="operations" if ops_s > bytes_s
                          else "bytes")
    return rows


def run_gen4_path(pipeline, counters, windows, dev, card):
    """Phase 9: the 1 Mpx serving path at full width; returns the launch
    counts of its run."""
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(7, stem="bfm_folded",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    run = pipeline.make_pipeline_p64(model, GEN4_SENSOR, folded=True,
                                     device=dev, dtype=torch.bfloat16)
    state = pipeline.new_state(B, GEN4_SENSOR, p64=True, device=dev)
    H2, W2 = GEN4_SENSOR[0] // 2, GEN4_SENSOR[1] // 2
    torch.cuda.reset_peak_memory_stats()

    for fn in counters.values():
        fn.launches = 0
    for i, (ev, nv) in enumerate(windows):
        state, vol = run.stages["encode_transform"](state, ev, nv)
        dets, keep = run.stages["detect"](vol)
        torch.cuda.synchronize()
        if not (torch.isfinite(state).all() and torch.isfinite(vol).all()
                and torch.isfinite(dets).all()):
            raise SystemExit(f"gen4 path window {i}: non-finite output")
        if vol.shape != (B, H2, W2 * 64) or dets.shape != (B, 100, 6):
            raise SystemExit(f"gen4 path window {i}: shapes {vol.shape}, "
                             f"{dets.shape}")
        n_valid_rows = int((dets[..., 5] > 0).sum().item())
        log(f"gen4 path window {i}: kept {int(keep.sum().item())} of "
            f"{n_valid_rows} boxes past conf 0.3 over {B} streams")
    launches = {k: fn.launches for k, fn in counters.items()}
    need = ("scatter_cnt_tsum", "taf_update_leaky_raw",
            "bfm_chain_apply_folded")
    if min(launches[k] for k in need) < len(windows):
        raise SystemExit(f"gen4 path did not go through its kernels: "
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
    log(f"gen4 path on {card}: encode_transform {enc_ms:.3f} ms, detect "
        f"{det_ms:.3f} ms per {B}-stream window batch; run_step "
        f"{step_s * 1e3:.3f} ms = {B / step_s:.1f} windows/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def run_p64_kernel_config(pipeline, counters, windows, dev):
    """Phase 10: stem bfm_p64_kernel (fold_output=False, chain in B7) at
    the full gen4 shape, the one phase 8 times B7 at; returns the launch
    counts of its run."""
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(7, stem="bfm_p64_kernel",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    run = pipeline.make_pipeline_p64(model, GEN4_SENSOR, folded=False,
                                     device=dev, dtype=torch.bfloat16)
    state = pipeline.new_state(B, GEN4_SENSOR, p64=True, device=dev)
    for fn in counters.values():
        fn.launches = 0
    for i, (ev, nv) in enumerate(windows):
        state, (dets, keep) = run(state, ev, nv)
        torch.cuda.synchronize()
        if not torch.isfinite(dets).all() or dets.shape != (B, 100, 6):
            raise SystemExit(f"bfm_p64_kernel window {i}: dets "
                             f"{tuple(dets.shape)} or non-finite")
        log(f"bfm_p64_kernel window {i}: kept {int(keep.sum().item())} "
            f"over {B} streams")
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches["bfm_chain_apply"] < len(windows):
        raise SystemExit(f"bfm_p64_kernel did not launch B7: {launches}")
    return launches


def check_small_p64_against_cpu(pipeline, dev):
    """Phase 11: the 1 Mpx slice on the card vs on the CPU, 64x96, f32
    without TF32, narrow AED with 7 classes. The stem's chain and its 3x3
    conv run in bf16 on both (as the JAX stem does), and the two bf16 convs
    round a few outputs in 10^4 the other way, so: states 1e-2, volumes
    2e-2, head outputs atol 1e-2, keep masks equal on at least 98% of the
    top-100 rows (a near-tie at conf 0.3 or IoU 0.6 may go either way)."""
    from frlw_evd_tpu_torch.models import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sensor = (64, 96)
    runs, states, models = {}, {}, {}
    for d in ("cpu", dev):
        models[d] = build_detector(7, stem="bfm_folded",
                                   in_channels=(32, 32, 32),
                                   stem_out_channels=16, head_width=32)
        pipeline.spread_random_weights_(models[d],
                                        torch.Generator().manual_seed(1))
        runs[d] = pipeline.make_pipeline_p64(models[d], sensor, folded=True,
                                             device=d, dtype=torch.float32)
        states[d] = pipeline.new_state(2, sensor, p64=True, device=d)
    ev, nv = pipeline.synth_events(np.random.default_rng(7), 3, 2, 1024,
                                   sensor)
    for i in range(3):
        out = {}
        for d, run in runs.items():
            states[d], vol = run.stages["encode_transform"](
                states[d], torch.from_numpy(ev[i]).to(d),
                torch.from_numpy(nv[i]).to(d))
            with torch.inference_mode():
                heads = [o.float().cpu() for o in models[d](vol)]
            out[d] = (vol, heads, *run.stages["detect"](vol))
        (c_vol, c_heads, _, c_keep), (g_vol, g_heads, g_dets, g_keep) = (
            out["cpu"], out[dev])
        st_err = (states[dev].cpu() - states["cpu"]).abs().max().item()
        vol_err = (g_vol.cpu().float() - c_vol.float()).abs().max().item()
        head_err = max((g - c).abs().max().item()
                       for g, c in zip(g_heads, c_heads))
        same = (g_keep.cpu() == c_keep).float().mean().item()
        if (st_err > 1e-2 or vol_err > 2e-2 or head_err > 1e-2
                or same < 0.98 or not torch.isfinite(g_dets).all()):
            raise SystemExit(f"small p64 window {i}: state err {st_err}, "
                             f"vol err {vol_err}, head err {head_err}, keep "
                             f"rows equal {same:.3f}, dets finite: "
                             f"{bool(torch.isfinite(g_dets).all())}")
        log(f"small p64 window {i}: card vs CPU state err {st_err:.2e}, vol "
            f"err {vol_err:.2e}, head err {head_err:.2e}, keep rows equal "
            f"{same:.1%} ({int(c_keep.sum())} kept on the CPU, "
            f"{int(g_keep.sum())} on the card)")


def check_pair_sorted(enc, ev_sets, rate):
    """Phase 12: B6 vs its twin at full gen4 shape on the p64 cells of the
    uniform and skewed windows and of a one-cell set (every slot of the
    uniform set in cell 1234). Counts exact; t-sums bitwise equal to the
    twin's (the steps' t - 1 are multiples of 2^-24, summed exactly as
    integers by the kernel and in f64 by the twin, each rounded once); two
    launches bitwise equal; the outputs in blocks poisoned with NaN. Times
    on each set beside index_add_, and on the uniform set the twin, the
    per-block-tile form (clusters of 1) and the plain sorted histogram."""
    H, W = GEN4_SENSOR
    size = H * W * 2
    plan = enc.scatter.tile_plan(size)
    alone = enc.scatter.tile_plan(size, cluster=1)
    err, cells = 0.0, {}
    for name, (ev, nv) in ev_sets.items():
        cells[name] = enc.event_cells(ev, nv, H, W, "p64")
    idx, tv, valid = cells["uniform"]
    B = idx.shape[0]
    log(f"B6 launch: {plan.describe(size, B)}")
    log(f"B6 per-block tiles: {alone.describe(size, B)}")
    cells["one_cell"] = (torch.full_like(idx, 1234), tv, valid)
    ms, library_ms = {}, {}
    for name, (idx, tv, valid) in cells.items():
        runs = []
        for _ in range(2):
            poisoned = poison(((B, size), torch.float32),
                              ((B, size), torch.float32))
            runs.append(enc.scatter_cnt_tsum_pallas_sorted(idx, tv, valid,
                                                           size))
            torch.cuda.synchronize()
            check_poisoned(f"B6 {name}", runs[-1], poisoned)
        (cnt, tsum), (cnt2, tsum2) = runs
        p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_sorted_plain(
            idx, tv, valid, size)
        torch.cuda.synchronize()
        same = torch.equal(cnt, cnt2) and torch.equal(tsum, tsum2)
        if not same or not torch.equal(cnt, p_cnt):
            raise SystemExit(f"B6 {name}: launches bitwise equal: {same}, "
                             f"counts equal to the twin's: "
                             f"{torch.equal(cnt, p_cnt)}")
        diff = (tsum - p_tsum).abs().max().item()
        if not torch.equal(tsum, p_tsum):
            raise SystemExit(f"B6 {name}: t-sums not bitwise equal to the "
                             f"twin's (max |d| {diff})")
        err = max(err, diff)
        log(f"B6 {name}: counts exact ({int(p_cnt.sum().item())} events), "
            f"t-sums bitwise equal to the twin's, two launches bitwise "
            f"equal, every cell written")
        del runs, cnt, tsum, cnt2, tsum2, p_cnt, p_tsum
        ms[name] = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
            idx, tv, valid, size))
        library_ms[name] = index_add_ms(idx, tv, valid, size)
    idx, tv, valid = cells["uniform"]
    alone_ms = time_ms(lambda: enc.scatter._exact_histogram(
        idx, tv, valid, size, alone))
    none = torch.zeros_like(valid)
    no_slots = [c[:, :0].contiguous() for c in (idx, tv, valid)]
    split = dict(empty=time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
                     *no_slots, size)),
                 scan=time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
                     idx, tv, none, size)),
                 planes=plane_write_ms(B, size))
    log(split_line("B6", split, ms["uniform"]))
    sorted_hist_ms = time_ms(lambda: enc.scatter_cnt_tsum_sorted(
        idx, tv, valid, size, False))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted_plain(
        idx, tv, valid, size), n=5)
    bytes_moved = idx.numel() * (4 + 4 + 1) + 2 * idx.shape[0] * size * 4
    bound_ms = bytes_moved / rate * 1e3
    log("B6: " + ", ".join(
        f"{k} {ms[k]:.3f} ms (index_add_ {library_ms[k]:.3f})" for k in ms)
        + f"; per-block tiles {alone_ms:.3f} ms on uniform; twin "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes); the plain "
        f"sorted histogram (scatter='sorted') {sorted_hist_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms["uniform"], plain_ms=plain_ms,
                library_ms=library_ms["uniform"], bound_ms=bound_ms,
                bound_by="bytes", ms_by_set=ms, library_ms_by_set=library_ms,
                per_block_tiles_ms=alone_ms, split_ms=split)


def check_update_v2(enc, ev_sets, dev, rate):
    """Phase 13: B5 vs its twin at full gen4 shape, stream 3 frozen: state
    exact, volume within one bf16 ulp; and B5 on B1's p64 planes equal to
    B3 on the same planes, bit for bit."""
    H, W = GEN4_SENSOR
    H2, W2 = H // 2, W // 2
    ev, nv = ev_sets["skewed"]
    nv = nv.clone()
    nv[3] = 0
    cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, height=H, width=W,
                                           layout="p64")
    g = torch.Generator(device=dev).manual_seed(0)
    state = -30.0 * torch.rand(B, H2, W2 * 64, device=dev, generator=g)
    state[:, :, ::5] = -6000.0
    frozen = state[3].clone()
    twin_state, raw_state = state.clone(), state.clone()
    planes = (cnt.view(B, H2, -1), tsum.view(B, H2, -1), anyv)
    hw = dict(height=H2, width=W2 * 4)
    _, vol = enc.taf_update_leaky_v2(state, *planes, **hw)
    _, r_vol = enc.taf_update_leaky_raw(raw_state, cnt, tsum, anyv, height=H,
                                        width=W)
    torch.cuda.synchronize()
    as_b3 = torch.equal(state, raw_state) and torch.equal(vol, r_vol)
    del raw_state, r_vol
    _, p_vol = enc.taf_update_leaky_v2_plain(twin_state, *planes, **hw)
    torch.cuda.synchronize()
    st_err = (state - twin_state).abs().max().item()
    vol_err = (vol.float() - p_vol.float()).abs().max().item()
    kept = torch.equal(state[3], frozen)
    if st_err != 0.0 or vol_err > 2.0 ** -8 or not kept or not as_b3:
        raise SystemExit(f"B5: state err {st_err}, vol err {vol_err}, frozen "
                         f"stream kept: {kept}, equal to B3: {as_b3}")
    log(f"B5: state exact, max |dvol| {vol_err:.3e}, frozen stream "
        f"unchanged; equal to B3 on the same planes, bit for bit")
    del vol, p_vol
    torch.cuda.empty_cache()

    def b3():
        return enc.taf_update_leaky_raw(state, cnt, tsum, anyv, height=H,
                                        width=W)

    def b5():
        return enc.taf_update_leaky_v2(state, *planes, **hw)
    b3_ms, ms, ms2, b3_ms2 = (time_ms(f) for f in (b3, b5, b5, b3))
    log(f"B5 {ms:.3f} / {ms2:.3f} ms and B3 {b3_ms:.3f} / {b3_ms2:.3f} ms on "
        f"the same state, timed in turns (B3, B5, B5, B3)")
    plain_ms = time_ms(lambda: enc.taf_update_leaky_v2_plain(
        twin_state, *planes, **hw), n=5)
    N = state.numel()
    bytes_moved = N * 4 * 2 + N * 2 + 2 * cnt.numel() * 4 + B * 4
    return dict(max_abs_err=max(st_err, vol_err), ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bytes_moved / rate * 1e3,
                bound_by="bytes")


def check_dense(enc, counters, ev_sets, rate):
    """Phase 14: B8 on its own path (launch counts zeroed, B8 through its
    entry on the folded cells of the GEN1 uniform and skewed windows, counts
    read), then against its twin on those, a one-cell set and the uniform
    set with t scaled by 1e6 (B1 and B6 would poison such t; B8 must not):
    counts exact, t-sums within cnt^2 * 2^-23 * max|t| (f32 adds in a
    run-dependent order; the twin sums in f64), every output cell written
    (poisoned blocks). Prints the tiling and the atomic instructions of
    the kernel's SASS (which f32 add the compiler emits). Timed beside B1
    (folded) and index_add_ in this call. Returns the row and the launch
    counts of its path."""
    H, W = GEN1_SENSOR
    size = H * W * 2
    cells = {name: enc.event_cells(ev, nv, H, W, "folded")
             for name, (ev, nv) in ev_sets.items()}
    for fn in counters.values():
        fn.launches = 0
    outs = {name: enc.scatter_cnt_tsum_pallas(*c, size)
            for name, c in cells.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches["scatter_cnt_tsum_pallas"] < len(cells):
        raise SystemExit(f"B8 path did not launch its kernel: {launches}")
    del outs
    B = cells["uniform"][0].shape[0]
    log(f"B8 launch: {enc.scatter.tile_plan(size).describe(size, B)}")
    ops = re.findall(r"\b(?:ATOMS|ATOM|RED|REDUX|ATOMG)\.[A-Z0-9_.]+",
                     sass("scatter_dense"))
    log(f"libscatter_dense.so SASS atomics: "
        f"{dict(sorted(Counter(ops).items()))}")
    idx, tv, valid = cells["uniform"]
    sets = dict(cells, one_cell=(torch.full_like(idx, 12345), tv, valid),
                t_1e6=(idx, tv * 1e6, valid))
    err = 0.0
    for name, (i_, t_, v_) in sets.items():
        poisoned = poison(((B, size), torch.float32),
                          ((B, size), torch.float32))
        cnt, tsum = enc.scatter_cnt_tsum_pallas(i_, t_, v_, size)
        torch.cuda.synchronize()
        check_poisoned(f"B8 {name}", (cnt, tsum), poisoned)
        p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_plain(i_, t_, v_, size)
        torch.cuda.synchronize()
        diff = (tsum - p_tsum).abs()
        t_max = t_.abs().max().item()
        if not torch.equal(cnt, p_cnt) or not bool(
                (diff <= p_cnt * p_cnt * 2.0 ** -23 * max(t_max, 1.0)).all()):
            raise SystemExit(f"B8 {name}: counts equal "
                             f"{torch.equal(cnt, p_cnt)}, max |dtsum| "
                             f"{diff.max().item()}")
        if t_max <= 1.0:
            err = max(err, diff.max().item())
        log(f"B8 {name}: counts exact ({int(p_cnt.sum().item())} events, "
            f"max {int(p_cnt.max().item())} a cell), max |dtsum| "
            f"{diff.max().item():.3e} (max |t| {t_max:.3g}), every cell "
            f"written")
        del cnt, tsum, p_cnt, p_tsum, diff
    ev, nv = ev_sets["uniform"]
    ms_by_set = {name: time_ms(lambda: enc.scatter_cnt_tsum_pallas(
        *sets[name], size)) for name in ("uniform", "skewed", "one_cell")}
    ms = ms_by_set["uniform"]
    tilings_ms = dense_tilings_ms(enc, idx, tv, valid, size)
    b1_ms = time_ms(lambda: enc.scatter_cnt_tsum(ev, nv, height=H, width=W))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_plain(
        idx, tv, valid, size), n=3, warm=1)
    library_ms = index_add_ms(idx, tv, valid, size)
    bytes_moved = idx.numel() * (4 + 4 + 1) + 2 * idx.shape[0] * size * 4
    bound_ms = bytes_moved / rate * 1e3
    log(f"B8: uniform {ms:.3f} ms, skewed {ms_by_set['skewed']:.3f}, "
        f"one-cell {ms_by_set['one_cell']:.3f}; B1 (folded, from events) "
        f"{b1_ms:.3f} ms and index_add_ {library_ms:.3f} ms in this call; "
        f"twin {plain_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes), "
        f"{bound_ms / ms:.1%} of it; on the uniform set under other "
        f"tilings: " + ", ".join(f"{k} {v:.3f} ms"
                                 for k, v in tilings_ms.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
                ms_by_set=ms_by_set, tilings_ms=tilings_ms), launches


def dense_tilings_ms(enc, idx, tv, valid, size):
    """B8's kernel launched under tilings other than tile_plan's one
    cluster of 8 blocks a stream at GEN1: per-block tiles (clusters of 1,
    each block reading every slot of its stream) and two clusters of 8
    (half the shared memory a block, so two blocks share an SM). Counts
    checked against the twin; returns {tiling: ms}."""
    from frlw_evd_tpu_torch.kernels import _build

    B_, E_ = idx.shape
    p_cnt, _ = enc.scatter_cnt_tsum_pallas_plain(idx, tv, valid, size)
    cnt = torch.empty(B_, size, device=idx.device)
    tsum = torch.empty_like(cnt)
    out = {}
    for name, plan in (("per-block tiles",
                        enc.scatter.tile_plan(size, cluster=1)),
                       ("two clusters of 8",
                        enc.scatter.TilePlan(2, 8, -(-size // 64) * 4))):
        def launch():
            _build.launch("scatter_dense", "scatter_cnt_tsum_dense",
                          (idx, tv, valid, cnt, tsum),
                          (B_, E_, size, *plan), idx.device)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(cnt, p_cnt):
            raise SystemExit(f"B8 with {name}: counts differ from the twin")
        out[name] = time_ms(launch)
    return out


def drive(name, encode, detect, state, counters, windows, need):
    """Zero the launch counts, run encode then detect on each window from
    `state`, check the outputs, and read the counts: every kernel in `need`
    must have launched on every window. Returns the counts and the state."""
    H2, W2 = GEN4_SENSOR[0] // 2, GEN4_SENSOR[1] // 2
    for fn in counters.values():
        fn.launches = 0
    for i, (ev, nv) in enumerate(windows):
        state, vol = encode(state, ev, nv)
        dets, keep = detect(vol)
        torch.cuda.synchronize()
        if not (torch.isfinite(state).all() and torch.isfinite(vol).all()
                and torch.isfinite(dets).all()):
            raise SystemExit(f"{name} window {i}: non-finite output")
        if vol.shape != (B, H2, W2 * 64) or dets.shape != (B, 100, 6):
            raise SystemExit(f"{name} window {i}: shapes {vol.shape}, "
                             f"{dets.shape}")
        log(f"{name} window {i}: kept {int(keep.sum().item())} of "
            f"{int((dets[..., 5] > 0).sum().item())} boxes past conf 0.3 "
            f"over {B} streams")
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches[k] for k in need) < len(windows):
        raise SystemExit(f"{name} did not go through its kernels: "
                         f"{launches}")
    return launches, state


def time_path(name, encode, detect, state, windows, card):
    """Per-stage times (CUDA events, after warm-up) and windows/s of
    encode + detect on the host clock, ending in a synchronize."""
    ev, nv = windows[0]
    enc_ms = time_ms(lambda: encode(state, ev, nv), n=5)
    _, vol = encode(state, ev, nv)
    det_ms = time_ms(lambda: detect(vol), n=3)
    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        ev, nv = windows[i % len(windows)]
        state, vol = encode(state, ev, nv)
        detect(vol)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    log(f"{name} on {card}: encode_transform {enc_ms:.3f} ms, detect "
        f"{det_ms:.3f} ms per {B}-stream window batch; step "
        f"{step_s * 1e3:.3f} ms = {B / step_s:.1f} windows/s")


def run_precise_sorted_paths(pipeline, enc, counters, windows, dev, card):
    """Phase 15: the 1 Mpx path through the new entries at full width.
    make_pipeline_p64(scatter="sorted") with the bfm_folded AED (7 classes,
    bf16), then taf_stream_step_kernel_p64(precise=True, fold_output=True)
    feeding the same pipeline's detect stage, 3 windows carrying state each.
    Returns the launch counts of both paths."""
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(7, stem="bfm_folded",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    run = pipeline.make_pipeline_p64(model, GEN4_SENSOR, "sorted",
                                     folded=True, device=dev,
                                     dtype=torch.bfloat16)
    H, W = GEN4_SENSOR
    detect = run.stages["detect"]
    paths = {
        "gen4_sorted": (run.stages["encode_transform"],
                        ("taf_update_leaky_v2", "bfm_chain_apply_folded")),
        "gen4_precise": (lambda st, ev, nv: enc.taf_stream_step_kernel_p64(
            st, ev, nv, height=H, width=W, precise=True, fold_output=True),
                         ("scatter_cnt_tsum_pallas_sorted",
                          "taf_update_leaky_v2", "bfm_chain_apply_folded")),
    }
    by_path = {}
    for name, (encode, need) in paths.items():
        state = pipeline.new_state(B, GEN4_SENSOR, p64=True, device=dev)
        by_path[name], state = drive(name, encode, detect, state, counters,
                                     windows, need)
        time_path(name, encode, detect, state, windows, card)
        del state
        torch.cuda.empty_cache()
    return by_path


def check_small_steps_against_cpu(enc, pipeline, dev):
    """Phase 16: the precise and the sorted p64 steps (64x96) and the
    precise GEN1 step (60x72) on a small input, card against CPU (the
    twins), 3 windows carrying state: phase 11's gates, states 1e-2 and
    volumes 2e-2."""
    steps = {
        "p64 precise": ((64, 96), True, dict(scatter="pallas", precise=True)),
        "p64 sorted": ((64, 96), True, dict(scatter="sorted")),
        "gen1 precise": ((60, 72), False, dict(scatter="pallas",
                                               precise=True)),
    }
    for name, (sensor, p64, kw) in steps.items():
        step = (enc.taf_stream_step_kernel_p64 if p64
                else enc.taf_stream_step_kernel)
        states = {d: pipeline.new_state(2, sensor, p64=p64, device=d)
                  for d in ("cpu", dev)}
        ev, nv = pipeline.synth_events_skewed(np.random.default_rng(7), 3, 2,
                                              1024, sensor)
        for i in range(3):
            vols = {}
            for d in states:
                states[d], vols[d] = step(
                    states[d], torch.from_numpy(ev[i]).to(d),
                    torch.from_numpy(nv[i]).to(d), height=sensor[0],
                    width=sensor[1], **kw)
            st_err = (states[dev].cpu() - states["cpu"]).abs().max().item()
            vol_err = (vols[dev].cpu().float()
                       - vols["cpu"].float()).abs().max().item()
            if st_err > 1e-2 or vol_err > 2e-2:
                raise SystemExit(f"small {name} window {i}: state err "
                                 f"{st_err}, vol err {vol_err}")
            log(f"small {name} window {i}: card vs CPU state err "
                f"{st_err:.2e}, vol err {vol_err:.2e}")


TRAIN_STEPS, TRAIN_WARMUP = 10, 2


def run_train_config(train, build_detector, counters, config, dev, card,
                     card_name):
    """Phases 17 and 18: `config` of train.TRAIN_CONFIGS at full width
    through train.run_train, with the checks listed in the docstring.
    Returns the phase's numbers."""
    cfg = train.TRAIN_CONFIGS[config]
    model = build_detector(cfg["num_classes"], stem="bfm", train=True,
                           generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for fn in counters.values():
        fn.launches = 0
    rep = train.run_train(config, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
                          model=model, device=dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise SystemExit(f"{config} launched a kernel: {launches}")
    losses = rep["losses"]
    if not all(np.isfinite(v) for lo in losses for v in lo.values()):
        raise SystemExit(f"{config}: a non-finite loss: {losses}")
    totals = [lo["total_loss"] for lo in losses]
    if max(totals) == min(totals):
        raise SystemExit(f"{config}: total_loss did not move: {totals}")
    params = dict(model.named_parameters())
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            continue
        if v.dtype != torch.float32:
            raise SystemExit(f"{config}: {k} is {v.dtype}, not f32")
        if torch.equal(v.cpu(), before[k]):
            kind = "master" if k in params else "BatchNorm statistic"
            raise SystemExit(f"{config}: {kind} {k} did not move")
    s_per_step = rep["ms_per_step"] / 1e3
    mfu = rep["flops_per_step"] / s_per_step / bf16_tensor_flops(card_name)
    log(f"{config} on {card}: {rep['ms_per_step']:.2f} ms/step at batch "
        f"{rep['batch']}, {rep['windows_per_s']:.1f} windows/s, peak memory "
        f"{rep['peak_bytes'] / 2**30:.2f} GiB, "
        f"{rep['flops_per_step'] / 1e12:.3f} TFLOP/step counted (matrix "
        f"products and convolutions, forward and backward), MFU {mfu:.2%} "
        f"of {bf16_tensor_flops(card_name) / 1e12:.0f} TFLOP/s dense bf16")
    log(f"{config} total_loss by step: "
        + ", ".join(f"{t:.4f}" for t in totals))
    return dict(ms_per_step=rep["ms_per_step"],
                windows_per_s=rep["windows_per_s"],
                peak_gib=rep["peak_bytes"] / 2**30,
                tflop_per_step=rep["flops_per_step"] / 1e12, mfu=mfu)


SMALL_TRAIN_GATES = {"losses": 2e-4, "statistics": 1e-5, "gradients": 1e-6,
                     "parameters": 1e-6}
STATS = ("running_mean", "running_var")


def small_train_batch(rng, H=64, W=96):
    """tests/test_train_p64.py's batch, as numpy: 4 volumes U(0, 1) of
    (H, W, 2K), 10 label rows [class, cx, cy, w, h] of which 3 hold gts
    of 2 classes."""
    imgs = rng.uniform(0, 1, (4, H, W, 2 * K)).astype(np.float32)
    labels = np.zeros((4, 10, 5), np.float32)
    for b in range(4):
        labels[b, :3] = [[rng.integers(0, 2), rng.uniform(20, W - 20),
                          rng.uniform(20, H - 20), rng.uniform(8, 30),
                          rng.uniform(8, 30)] for _ in range(3)]
    return imgs, labels


def small_sgd_step(train, build_detector, device, dtype, imgs, labels):
    """One SGD(1e-2) step of the seeded small AED (32 wide, dropout 0) in
    `dtype` on `device`: (losses, gradients, float state after), as f64 on
    the CPU."""
    model = build_detector(2, stem="bfm", train=True, dropout_rate=0.0,
                           generator=torch.Generator().manual_seed(0),
                           in_channels=(32, 32, 32), stem_out_channels=16,
                           head_width=32)
    if dtype == torch.float32:
        state = train.create_train_state(model, train.sgd(1e-2),
                                         device=device)
    else:
        model.to(device, dtype)
        state = train.TrainState(0, model,
                                 train.sgd(1e-2).make(model.parameters()))
    step = train.make_train_step((8, 16, 32), 2, 2.5, device=device)
    losses = step(state, torch.from_numpy(imgs).to(dtype),
                  torch.from_numpy(labels), torch.Generator(device=device))
    return ({k: v.item() for k, v in losses.items()},
            {k: p.grad.double().cpu() for k, p in model.named_parameters()},
            {k: v.double().cpu() for k, v in model.state_dict().items()
             if v.is_floating_point()})


def small_train_errors(train, build_detector, dev) -> dict:
    """small_sgd_step on `dev` against the CPU, TF32 off meanwhile: in f32
    the losses' largest relative error and the running statistics' largest
    absolute error; with the network in f64 the gradients' error over each
    leaf's largest magnitude and the parameters' absolute error after the
    step. Held to SMALL_TRAIN_GATES, the gates of
    tests/test_torch_port_train.py."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        imgs, labels = small_train_batch(np.random.default_rng(0))
        runs = {d: small_sgd_step(train, build_detector, d, torch.float32,
                                  imgs, labels) for d in ("cpu", dev)}
        err = {"losses": max(abs(runs[dev][0][k] / v - 1)
                             for k, v in runs["cpu"][0].items()),
               "statistics": max((runs[dev][2][k] - v).abs().max().item()
                                 for k, v in runs["cpu"][2].items()
                                 if k.endswith(STATS))}
        runs = {d: small_sgd_step(train, build_detector, d, torch.float64,
                                  imgs, labels) for d in ("cpu", dev)}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    err["gradients"] = max((runs[dev][1][k] - g).abs().max().item()
                           / max(g.abs().max().item(), 1e-12)
                           for k, g in runs["cpu"][1].items())
    err["parameters"] = max((runs[dev][2][k] - v).abs().max().item()
                            for k, v in runs["cpu"][2].items()
                            if not k.endswith(STATS))
    return err


def check_small_train_against_cpu(train, build_detector, dev):
    """Phase 19: small_train_errors within SMALL_TRAIN_GATES."""
    err = small_train_errors(train, build_detector, dev)
    log(f"small train step, card vs CPU: f32 losses rel err "
        f"{err['losses']:.2e}, running statistics err "
        f"{err['statistics']:.2e}; f64 network: gradients err "
        f"{err['gradients']:.2e} of each leaf's largest, parameters after "
        f"SGD err {err['parameters']:.2e}")
    if any(err[k] > gate for k, gate in SMALL_TRAIN_GATES.items()):
        raise SystemExit(f"small train step: card and CPU disagree beyond "
                         f"the gates {SMALL_TRAIN_GATES}")


def check_long_streams(enc, pipeline, dev, rate):
    """Phase 20: B1 and B6 at E = 2^19 on 4 streams at the gen4 sensor,
    uniform and one-cell sets: one launch a chunk of slots, B1's counts
    and any_ev exact and t-sums within cnt^2 * 2^-23 of its twin's, B6 bit
    for bit with its twin; the time of each over its chunks."""
    H, W = GEN4_SENSOR
    size = H * W * 2
    E_long = 2 ** 19
    chunks = len(enc.scatter.slot_chunks(E_long))
    ev, nv = pipeline.synth_events(np.random.default_rng(5), 1, 4, E_long,
                                   GEN4_SENSOR)
    ev, nv = torch.from_numpy(ev[0]).to(dev), torch.from_numpy(nv[0]).to(dev)
    sets = {"uniform": (ev, nv), "one_cell": (one_cell_events(ev), nv)}
    for name, (ev, nv) in sets.items():
        before = enc.scatter_cnt_tsum.launches
        cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, height=H, width=W,
                                               layout="p64")
        torch.cuda.synchronize()
        n_b1 = enc.scatter_cnt_tsum.launches - before
        p_cnt, p_tsum, p_any = enc.scatter_cnt_tsum_plain(
            ev, nv, height=H, width=W, layout="p64")
        b1_ok = (torch.equal(cnt, p_cnt) and torch.equal(anyv, p_any)
                 and bool(((tsum - p_tsum).abs()
                           <= p_cnt * p_cnt * 2.0 ** -23).all()))
        del cnt, tsum, p_tsum
        idx, tv, valid = enc.event_cells(ev, nv, H, W, "p64")
        before = enc.scatter_cnt_tsum_pallas_sorted.launches
        cnt6, tsum6 = enc.scatter_cnt_tsum_pallas_sorted(idx, tv, valid,
                                                         size)
        torch.cuda.synchronize()
        n_b6 = enc.scatter_cnt_tsum_pallas_sorted.launches - before
        q_cnt, q_tsum = enc.scatter_cnt_tsum_pallas_sorted_plain(
            idx, tv, valid, size)
        b6_ok = torch.equal(cnt6, q_cnt) and torch.equal(tsum6, q_tsum)
        if not (b1_ok and b6_ok and n_b1 == n_b6 == chunks
                and torch.equal(q_cnt, p_cnt)):
            raise SystemExit(f"E = 2^19 {name}: B1 agrees {b1_ok} with "
                             f"{n_b1} launches, B6 bitwise {b6_ok} with "
                             f"{n_b6}, {chunks} chunks")
        del cnt6, tsum6, q_cnt, q_tsum, p_cnt
        b1_ms = time_ms(lambda: enc.scatter_cnt_tsum(
            ev, nv, height=H, width=W, layout="p64"), n=5)
        b6_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
            idx, tv, valid, size), n=5)
        B_ = ev.shape[0]
        b1_bound = (ev.numel() * 4 + 2 * B_ * size * 4) / rate * 1e3
        b6_bound = (idx.numel() * 9 + 2 * B_ * size * 4) / rate * 1e3
        log(f"E = 2^19 {name} ({B_} streams, {chunks} launches a call): B1 "
            f"{b1_ms:.3f} ms (bound {b1_bound:.4f}), B6 {b6_ms:.3f} ms "
            f"(bound {b6_bound:.4f}); counts exact, B6 bitwise equal to its "
            f"twin")
        del idx, tv, valid
        torch.cuda.empty_cache()


def gen1_model(build_detector, pipeline):
    """Phase 4's full-width GEN1 AED with its seeded random weights, f32 on
    the CPU."""
    model = build_detector(2, stem="bfm",
                           generator=torch.Generator().manual_seed(0))
    return pipeline.spread_random_weights_(model,
                                           torch.Generator().manual_seed(1))


def int8_site_shapes(quantize, model, input_shape):
    """{(k, stride, Cin, Cout, H, W): sites} of the model's int8 sites, H x W
    their input, from one forward of a zero input of `input_shape` (one
    image, the model's input layout) under hooks."""
    shapes = Counter()

    def record(conv):
        def hook(_module, args):
            shapes[(conv.kernel_size[0], conv.stride[0], conv.in_channels,
                    conv.out_channels, *args[0].shape[2:])] += 1
        return hook
    handles = [m.register_forward_pre_hook(record(m))
               for m in quantize.eligible_sites(model).values()]
    p = next(model.parameters())
    with torch.inference_mode():
        model(torch.zeros(1, *input_shape, dtype=p.dtype, device=p.device))
    for h in handles:
        h.remove()
    return shapes


def gen4_int8_model(build_detector, pipeline):
    """Phase 9's 1 Mpx AED (stem bfm_folded, 7 classes) with phase 22's
    BatchNorm scales U(1, 1.75) (int8_gen1_model says why), f32 on the
    CPU."""
    model = build_detector(7, stem="bfm_folded",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(1.0, 1.75, generator=g)
    return model


def int8_sites_on_card(quantize, shapes, rate, int8_ops, label, g,
                       time_twin):
    """int8_conv2d against its twin at each (k, stride, Cin, Cout, H, W)
    of `shapes` at B = 128, on a bf16 channels_last activation N(0, 1)
    with sx = 3 / 127 (|x| > 3 clips), codes U[-127, 127] and dequant
    scales U(0, 1e-3): int32 sums equal, bf16 outputs bit for bit, from
    int8_conv2d and from an Int8Site of the same codes. Prints
    each site's time beside its bound, tile plan, torch._int_mm on the same
    codes (1x1 sites, checked equal to the sums) and cuDNN's bf16 conv;
    the twin is timed when `time_twin`. Returns the per-window totals."""
    totals = Counter()
    by_site = []
    for (k, s, cin, cout, h, w), n in sorted(shapes.items()):
        x = torch.randn(B, cin, h, w, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        inv = 127.0 / 3.0
        wq = torch.randint(-127, 128, (cout, k, k, cin), device="cuda",
                           generator=g, dtype=torch.int8)
        scale = torch.rand(cout, device="cuda", generator=g) * 1e-3
        out, acc = quantize.int8_conv2d(x, wq, scale, inv, stride=s,
                                        return_acc=True)
        p_out, p_acc = quantize.int8_conv2d_plain(x, wq, scale, inv,
                                                  stride=s, return_acc=True)
        torch.cuda.synchronize()
        if not (torch.equal(acc, p_acc) and torch.equal(out, p_out)):
            raise SystemExit(f"int8_conv2d {label} k{k} s{s} {cin}->{cout} "
                             f"{h}x{w}: sums equal {torch.equal(acc, p_acc)}, "
                             f"outputs bitwise equal "
                             f"{torch.equal(out, p_out)}")
        del p_out, p_acc
        # the path's launch: an Int8Site, whose weight map is encoded once
        # (its dequant scale is scale * sx), held to the twin bit for bit
        # and timed
        conv = torch.nn.Conv2d(cin, cout, k, s, (k - 1) // 2, bias=False,
                               device="cuda")
        site = quantize.Int8Site(conv, 1.0 / inv, wq.permute(0, 3, 1, 2),
                                 scale)
        if not torch.equal(site(x), quantize.int8_conv2d_plain(
                x, wq, site.scale, site.inv, stride=s)):
            raise SystemExit(f"Int8Site {label} k{k} s{s} {cin}->{cout} "
                             f"{h}x{w}: outputs differ from the twin")
        ms = time_ms(lambda: site(x))
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        for _ in range(20):
            site(x)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        del conv, site
        plain_ms = (time_ms(lambda: quantize.int8_conv2d_plain(
            x, wq, scale, inv, stride=s), n=2, warm=1) if time_twin else None)
        w_bf = torch.randn(cout, cin, k, k, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cudnn_ms = time_ms(lambda: torch.nn.functional.conv2d(
            x, w_bf, stride=s, padding=(k - 1) // 2))
        int_mm_ms = None
        if k == 1 and s == 1:
            a = quantize.quantize_activation(x, inv).to(torch.int8).permute(
                0, 2, 3, 1).reshape(-1, cin)
            b = wq.view(cout, cin).t()
            if not torch.equal(torch._int_mm(a, b),
                               acc.permute(0, 2, 3, 1).reshape(-1, cout)):
                raise SystemExit(f"torch._int_mm differs from int8_conv2d's "
                                 f"sums at {cin}->{cout} {h}x{w}")
            int_mm_ms = time_ms(lambda: torch._int_mm(a, b))
            totals["ms_1x1"] += n * ms
            totals["int_mm_1x1"] += n * int_mm_ms
            del a, b
        ho, wo = out.shape[2:]
        macs = B * ho * wo * cout * cin * k * k
        nbytes = x.numel() * 2 + wq.numel() + scale.numel() * 4 + out.numel() * 2
        bound = max(nbytes / rate, 2 * macs / int8_ops) * 1e3
        by = "operations" if 2 * macs / int8_ops > nbytes / rate else "bytes"
        plan = quantize.tile_plan(B, h, w, cin, cout, k, s)
        log(f"int8_conv2d {label} k{k} s{s} {cin}->{cout} {h}x{w} (x{n} a "
            f"window): {ms:.4f} ms, bound {bound:.4f} ({by}, "
            f"{bound / ms:.1%}; {2 * macs / ms * 1e-9:.0f} TOP/s), twin "
            + (f"{plain_ms:.3f}" if plain_ms is not None else "-")
            + ", _int_mm "
            + (f"{int_mm_ms:.4f}" if int_mm_ms is not None else "-")
            + f", cuDNN bf16 {cudnn_ms:.4f}; host {host_us:.1f} us a launch; "
            f"plan bm {plan.bm} bn {plan.bn} stages {plan.stages} smem "
            f"{plan.smem} grid {plan.grid} tiles {plan.tiles}; sums equal, "
            f"outputs bitwise")
        by_site.append(dict(k=k, stride=s, cin=cin, cout=cout, hw=[h, w],
                            sites=n, ms=ms, bound_ms=bound, bound_by=by,
                            plain_ms=plain_ms, int_mm_ms=int_mm_ms,
                            cudnn_bf16_ms=cudnn_ms, host_us=host_us,
                            plan=plan._asdict()))
        for key, v in (("ms", ms), ("plain_ms", plain_ms or 0.0),
                       ("host_ms", host_us * 1e-3),
                       ("cudnn", cudnn_ms), ("bytes", nbytes),
                       ("ops", 2 * macs)):
            totals[key] += n * v
        del x, wq, out, acc, w_bf
        torch.cuda.empty_cache()
    t_bytes, t_ops = totals["bytes"] / rate * 1e3, totals["ops"] / int8_ops * 1e3
    log(f"int8_conv2d {label} per window ({sum(shapes.values())} sites, "
        f"{len(shapes)} shapes): {totals['ms']:.3f} ms, bound "
        f"{max(t_bytes, t_ops):.3f} (bytes {t_bytes:.3f}, operations "
        f"{t_ops:.3f}), cuDNN bf16 {totals['cudnn']:.3f}; 1x1 sites "
        f"{totals['ms_1x1']:.3f} ms against _int_mm "
        f"{totals['int_mm_1x1']:.3f}; host {totals['host_ms']:.3f} ms of "
        f"launches")
    return dict(ms=totals["ms"], plain_ms=totals["plain_ms"],
                host_ms=totals["host_ms"],
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops > t_bytes else "bytes",
                cudnn_bf16_ms=totals["cudnn"], ms_1x1=totals["ms_1x1"],
                int_mm_1x1_ms=totals["int_mm_1x1"], by_site=by_site)


def weight_map_host_us(quantize):
    """Host microseconds of one weight_map (libcuda's
    cuTensorMapEncodeTiled behind a ctypes call): what a direct
    int8_conv2d call adds, which encodes the map for the call. The path
    caches one map a site (Int8Site) and encodes none for the activation,
    which is read without TMA."""
    wq = torch.zeros(256, 3, 3, 256, dtype=torch.int8, device="cuda")
    quantize.weight_map(wq)
    t0 = time.perf_counter()
    for _ in range(200):
        quantize.weight_map(wq)
    return (time.perf_counter() - t0) / 200 * 1e6


def check_int8_conv(quantize, build_detector, pipeline, rate, card_name):
    """Phase 21: int8_conv2d against its twin at every distinct int8 site
    shape of the GEN1 AED and of the gen4 AED (stem bfm_folded, 7
    classes, 512x640) at B = 128 (int8_sites_on_card); the SASS must hold
    IGMMA (wgmma) and no STL / LDL; the host cost of a weight map. Returns
    the row: GEN1 per-window sums, the gen4 ones under "gen4"."""
    int8_ops = _rate(INT8_TENSOR_OPS_PER_S, card_name)
    check_mma_sass("int8_conv", "IGMMA")
    map_us = weight_map_host_us(quantize)
    log(f"int8_conv2d weight map: {map_us:.2f} us of host time an encode "
        f"(once a site; the path encodes no map a launch)")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for label, make, volume, twin in (
            ("GEN1", gen1_model, GEN1_VOLUME, True),
            ("gen4", gen4_int8_model, GEN4_VOLUME, False)):
        model = make(build_detector, pipeline).to("cuda", torch.bfloat16)
        shapes = int8_site_shapes(quantize, model, volume)
        del model
        rows[label] = int8_sites_on_card(quantize, shapes, rate, int8_ops,
                                         label, g, twin)
    row = rows["GEN1"]
    return dict(row, max_abs_err=0.0, library_ms=None, map_host_us=map_us,
                gen4={k: v for k, v in rows["gen4"].items()
                      if k != "plain_ms"})


def int8_gen1_model(build_detector, pipeline):
    """Phase 4's AED with its BatchNorm scales drawn from U(1, 1.75) in
    place of U(1, 2). Random weights have no trained structure, and the
    head-map gate only means something between two regimes of this 61-site
    deep net: with the scales at 1 (the init) the maps are bias-dominated
    and barely move; at U(1, 2) the net amplifies the 1-2% error of every
    site (JAX's per-site regime) to 0.095 at stride 32 on the card. At
    U(1, 1.75) the maps carry signal (NMS suppresses boxes) and int8 moves
    them 0.03-0.05 (PERF.md, section 6)."""
    model = gen1_model(build_detector, pipeline)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(1.0, 1.75, generator=g)
    return model


def head_maps_rel_l2(model, vol, ctx):
    """Relative L2 of each level's head maps with and without `ctx`."""
    with torch.inference_mode():
        base = [o.double() for o in model(vol)]
        with ctx:
            quant = [o.double() for o in model(vol)]
    return [((q - b).norm() / b.norm()).item() for q, b in zip(quant, base)]


def int8_site_errors(model, vol, ctx):
    """{key: relative L2 of the site's int8 conv against its own conv} on
    the unquantized forward's inputs, every site on the reference path
    (tests/test_quantize.py:140-159)."""
    errs = {}

    def compare(key, site):
        def hook(_module, args, out):
            q = site(args[0]).double()
            errs[key] = ((q - out.double()).norm() / out.double().norm()
                         ).item()
        return hook
    handles = [conv.register_forward_hook(compare(key, site))
               for key, (conv, site) in ctx.sites.items()]
    with torch.inference_mode():
        model(vol)
    for h in handles:
        h.remove()
    return errs


def run_int8_path(pipeline, quantize, counters, windows, card, *, label,
                  model, make, state, need, n_windows):
    """An int8 serving path at full width: `make(quant)` builds it (bf16
    with quant None), calibrated on the live encode output of windows[:2]
    (pipeline.calibrate_pipeline, from `state`), then n_windows windows
    carrying state: int8_conv2d launched (sites) x (windows) times and
    each kernel of `need` on every window, outputs finite; every site
    within relative L2 0.04 of its bf16 conv and the head maps within 0.08
    of bf16's per level (tests/test_quantize.py's gates); encode_transform,
    detect and windows/s of int8 and bf16 in turns. Returns the launch
    counts of the int8 run."""
    f32_state = {k: v.clone() for k, v in model.state_dict().items()}
    bf16 = make(None)
    quant = pipeline.calibrate_pipeline(bf16, model, f32_state, state,
                                        windows[:2])
    sites = len(quantize.eligible_sites(model))
    if set(quant[0]) != set(quantize.eligible_sites(model)):
        raise SystemExit(f"{label} int8: {len(quant[0])} sites calibrated "
                         f"of {sites}")
    int8 = make(quant)
    runs = windows[2:2 + n_windows]
    for fn in counters.values():
        fn.launches = 0
    for i, (ev, nv) in enumerate(runs):
        state, vol = int8.stages["encode_transform"](state, ev, nv)
        dets, keep = int8.stages["detect"](vol)
        torch.cuda.synchronize()
        if not (torch.isfinite(state).all() and torch.isfinite(vol).all()
                and torch.isfinite(dets).all()):
            raise SystemExit(f"{label} int8 path window {i}: non-finite "
                             f"output")
        if dets.shape != (B, 100, 6):
            raise SystemExit(f"{label} int8 path window {i}: dets "
                             f"{dets.shape}")
        log(f"{label} int8 path window {i}: kept {int(keep.sum().item())} "
            f"of {int((dets[..., 5] > 0).sum().item())} boxes past conf 0.3 "
            f"over {B} streams, every output finite")
    launches = {k: fn.launches for k, fn in counters.items()}
    if (launches["int8_conv2d"] != sites * len(runs)
            or min(launches[k] for k in need) < len(runs)):
        raise SystemExit(f"{label} int8 path: {sites} sites x {len(runs)} "
                         f"windows, launches {launches}")
    ctx = quantize.int8_ctx(model, *quant)
    errs = int8_site_errors(model, vol, ctx)
    worst = max(errs, key=errs.get)
    log(f"{label} int8 sites against their bf16 convs, relative L2: median "
        f"{sorted(errs.values())[len(errs) // 2]:.4f}, largest "
        f"{errs[worst]:.4f} ({worst}), smallest {min(errs.values()):.4f}")
    if len(errs) != sites or not all(1e-4 < e < 0.04 for e in errs.values()):
        raise SystemExit(f"{label} int8 sites beyond relative L2 0.04: "
                         f"{errs}")
    rel = head_maps_rel_l2(model, vol, ctx)
    log(f"{label} int8 head maps against bf16, relative L2 per level: "
        + ", ".join(f"{r:.4f}" for r in rel))
    if not all(0 < r < 0.08 for r in rel):
        raise SystemExit(f"{label} int8 head maps beyond relative L2 0.08: "
                         f"{rel}")
    del ctx

    ev, nv = windows[0]
    times = {}
    for name in ("bf16", "int8", "int8", "bf16"):
        run = int8 if name == "int8" else bf16
        enc_ms = time_ms(lambda: run.stages["encode_transform"](state, ev,
                                                                 nv), n=5)
        det_ms = time_ms(lambda: run.stages["detect"](vol), n=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            state, _ = run(state, *runs[i % len(runs)])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
        times.setdefault(name, []).append((enc_ms, det_ms, step_ms))
    for name, rows in times.items():
        log(f"{label} {name} path on {card}: encode_transform "
            + " / ".join(f"{r[0]:.3f}" for r in rows) + " ms, detect "
            + " / ".join(f"{r[1]:.3f}" for r in rows) + " ms, run_step "
            + " / ".join(f"{r[2]:.3f} ms = {B / r[2] * 1e3:.1f}"
                         for r in rows) + " windows/s")
    return launches


def run_gen1_int8_path(pipeline, quantize, build_detector, counters,
                       windows, dev, card):
    """Phase 22: the GEN1 int8 serving path (int8_gen1_model, bf16;
    bench.py --config gen1_taf --dtype int8), INT8_WINDOWS windows; B1 and
    B2 on every window (run_int8_path)."""
    model = int8_gen1_model(build_detector, pipeline)

    def make(quant):
        return pipeline.make_pipeline_kernel(model, GEN1_SENSOR, GEN1_INPUT,
                                             device=dev, quant=quant)
    return run_int8_path(
        pipeline, quantize, counters, windows, card, label="GEN1",
        model=model, make=make,
        state=pipeline.new_state(B, GEN1_SENSOR, device=dev),
        need=("scatter_cnt_tsum", "taf_update_leaky"),
        n_windows=INT8_WINDOWS)


def run_gen4_int8_path(pipeline, quantize, build_detector, counters,
                       windows, dev, card):
    """Phase 23: the 1 Mpx int8 serving path (gen4_int8_model: stem
    bfm_folded, 7 classes, 512x640, bf16; make_pipeline_p64(quant=...), as
    bench.py --config gen4_taf --dtype int8 builds it), GEN4_INT8_WINDOWS
    windows; B1 (p64 order), B3 and B4 on every window (run_int8_path)."""
    model = gen4_int8_model(build_detector, pipeline)

    def make(quant):
        return pipeline.make_pipeline_p64(model, GEN4_SENSOR, folded=True,
                                          device=dev, quant=quant)
    return run_int8_path(
        pipeline, quantize, counters, windows, card, label="gen4",
        model=model, make=make,
        state=pipeline.new_state(B, GEN4_SENSOR, p64=True, device=dev),
        need=("scatter_cnt_tsum", "taf_update_leaky_raw",
              "bfm_chain_apply_folded"),
        n_windows=GEN4_INT8_WINDOWS)


TAF_WINDOWS = 3
# phase 24's gate on a step's volume against the reference's: two bf16
# ulps at the volume's top (2^-8 each), where the two compute one function
# up to the rounding of the t-sums; the kernels' t-sums themselves are held
# to their twins bit for bit (check_step_kernels, phases 2, 3 and 12)
VOLUME_TOL = 2 * 2.0 ** -8
SERVING_WINDOWS = 4
ENCODER_STEPS, ENCODER_WINDOWS = 50, 10     # bench.py:45, :627
# phase 26 times ENCODER_STEPS windows this many times and reports the
# median: one run of 50 windows is tens of ms on a shared host's clock
ENCODER_REPEATS = 5
B1, B2, B6 = ("scatter_cnt_tsum", "taf_update_leaky",
              "scatter_cnt_tsum_pallas_sorted")


def taf_step_variants(enc, sensor):
    """Phase 24's variants at `sensor`: name → (fresh state, step(state,
    ev, nv) → (state, the p64 K = 4 step's volume or None), volume(state)
    → (B, H, W, 2K) bf16 for the steps that make none, the kernels that
    must launch on every window). The unpacked, packed and folded steps
    run with precise=False, as the serving pipelines call them, unless
    the name says precise."""
    st = enc.streaming
    H, W = sensor
    dev = torch.device("cuda")

    def leaky(s):
        return (enc.leaky_transform(s) / 255.0).to(torch.bfloat16)

    def unpacked(**kw):
        def step(s, ev, nv):
            return st.taf_stream_step(s, ev, nv, precise=False, **kw), None
        return (torch.full((B, H, W, 2, K), -6000.0, device=dev), step,
                lambda s: leaky(st.taf_pack_state(s)))

    def packed(scatter, precise=False):
        def step(s, ev, nv):
            return st.taf_stream_step_packed(s, ev, nv, scatter=scatter,
                                             precise=precise), None
        return (torch.full((B, H, W, 2 * K), -6000.0, device=dev), step,
                leaky)

    def folded(scatter):
        def step(s, ev, nv):
            return st.taf_stream_step_folded(s, ev, nv, height=H, width=W,
                                             scatter=scatter), None
        return (enc.init_state(B, H, W, K, device=dev), step,
                lambda s: leaky(s).view(B, H, W, 2 * K))

    def p64_k4(scatter, precise=False):
        def step(s, ev, nv):
            return enc.taf_stream_step_kernel_p64(
                s, ev, nv, height=H, width=W, scatter=scatter,
                precise=precise, fold_output=True)
        return enc.p64_init_state(B, H, W, K=4, device=dev), step, None

    if sensor == GEN1_SENSOR:
        return {
            "gen1_unpacked_mxu": (*unpacked(use_mxu=True), (B6,)),
            "gen1_unpacked_sorted": (*unpacked(use_sorted=True), ()),
            "gen1_unpacked_exact": (*unpacked(use_mxu=False), ()),
            "gen1_packed_pallas": (*packed("pallas"), (B1,)),
            "gen1_packed_precise": (*packed("pallas", True), (B6,)),
            "gen1_packed_sorted": (*packed("sorted"), ()),
            "gen1_packed_mxu": (*packed("mxu"), (B6,)),
            "gen1_packed_xla": (*packed("xla"), ()),
        }
    return {
        "gen4_packed_pallas": (*packed("pallas"), (B1,)),
        "gen4_packed_sorted": (*packed("sorted"), ()),
        "gen4_folded_pallas": (*folded("pallas"), (B1, B2)),
        "gen4_folded_sorted": (*folded("sorted"), (B2,)),
        "gen4_p64k4_raw": (*p64_k4("pallas"), (B1, B2)),
        "gen4_p64k4_precise": (*p64_k4("pallas", True), (B6, B2)),
        "gen4_p64k4_sorted": (*p64_k4("sorted"), (B2,)),
    }


def taf_reference(enc, pipeline, sensor, windows):
    """The volumes phase 24 holds its variants to, after TAF_WINDOWS
    windows from a fresh queue: taf_stream_step_kernel's (B1 → B2) and,
    at gen4, the first 8 channels of each 16-channel subpixel block of
    taf_stream_step_kernel_p64's (K = 8, raw: B1 → B3), the four newest
    bins that a K = 4 queue holds."""
    H, W = sensor
    state = pipeline.new_state(B, sensor, device="cuda")
    for ev, nv in windows:
        state, vol = enc.taf_stream_step_kernel(state, ev, nv, height=H,
                                                width=W)
    refs = {"folded": vol}
    del state
    if sensor == GEN4_SENSOR:
        state = pipeline.new_state(B, sensor, p64=True, device="cuda")
        for ev, nv in windows:
            state, vol8 = enc.taf_stream_step_kernel_p64(
                state, ev, nv, height=H, width=W, fold_output=True)
        refs["p64"] = vol8.view(B, H // 2, -1, 16)[..., :8].reshape(
            B, H // 2, -1)
        del state
    return refs


def check_step_kernels(enc, windows, sensor, dev):
    """Phase 24's kernels at the shapes its steps give them that no earlier
    phase holds to the twins, on the skewed window with stream 3 emptied:
    at GEN1, B6 on the folded cells (145920 a stream) with the raw t and
    with bf16(t) (scatter_cnt_tsum_mxu's addends), counts and t-sums bit
    for bit with its twin (phase 12); at gen4, B1 in the folded order
    (phase 2's gates), and B2 on B1's planes at the gen4 folded queue
    (2K = 16) and at the p64 K = 4 geometry (H/2 rows, (W/2)*4 columns,
    2K = 8), state bit for bit and volume within one bf16 ulp (phase 3).
    Prints the device ms of each launch beside its twin's."""
    H, W = sensor
    size = H * W * 2
    ev, nv = windows[-1]
    nv = nv.clone()
    nv[3] = 0
    if sensor == GEN1_SENSOR:
        idx, tv, valid = enc.event_cells(ev, nv, H, W)
        for label, t in (("t", tv), ("bf16(t)", tv.to(torch.bfloat16)
                                     .to(torch.float32))):
            cnt, tsum = enc.scatter_cnt_tsum_pallas_sorted(idx, t, valid,
                                                           size)
            p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_sorted_plain(
                idx, t, valid, size)
            torch.cuda.synchronize()
            if not (torch.equal(cnt, p_cnt) and torch.equal(tsum, p_tsum)):
                raise SystemExit(
                    f"B6 GEN1 folded on {label}: counts equal "
                    f"{torch.equal(cnt, p_cnt)}, t-sums differ by up to "
                    f"{(tsum - p_tsum).abs().max().item()}")
            ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
                idx, t, valid, size))
            plain_ms = time_ms(
                lambda: enc.scatter_cnt_tsum_pallas_sorted_plain(
                    idx, t, valid, size), n=3)
            log(f"B6 GEN1 folded on {label}: counts and t-sums bitwise equal "
                f"to the twin's ({int(p_cnt.sum().item())} events); "
                f"{ms:.3f} ms, twin {plain_ms:.3f} ms")
        return
    kw = dict(height=H, width=W)
    cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, **kw)
    p_cnt, p_tsum, p_any = enc.scatter_cnt_tsum_plain(ev, nv, **kw)
    torch.cuda.synchronize()
    diff = (tsum - p_tsum).abs()
    if not (torch.equal(cnt, p_cnt) and torch.equal(anyv, p_any) and bool(
            (diff <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all())):
        raise SystemExit(f"B1 gen4 folded: counts equal "
                         f"{torch.equal(cnt, p_cnt)}, max |dtsum| "
                         f"{diff.max().item()}")
    log(f"B1 gen4 folded: counts exact, max |dtsum| {diff.max().item():.3e}")
    del cnt, tsum, anyv, diff
    cnt4, tsum4, any4 = enc.scatter_cnt_tsum_plain(ev, nv, layout="p64", **kw)
    for label, planes, hw, C in (
            ("gen4 folded", (p_cnt, p_tsum, p_any), (H, W), 2 * K),
            ("p64 K = 4", (cnt4, tsum4, any4), (H // 2, W // 2 * 4), K)):
        state, twin, _ = b2_against_twin(enc, label, *planes, *hw, C, dev)
        hkw = dict(height=hw[0], width=hw[1])
        ms = time_ms(lambda: enc.taf_update_leaky(state, *planes, **hkw))
        plain_ms = time_ms(lambda: enc.taf_update_leaky_plain(
            twin, *planes, **hkw), n=3)
        log(f"B2 {label} ({B}, {hw[0]}, {hw[1]} * {C}): {ms:.3f} ms, twin "
            f"{plain_ms:.3f} ms")
        del state, twin
        torch.cuda.empty_cache()


def run_taf_steps(enc, pipeline, counters, dev, card):
    """Phase 24: the unpacked, packed, folded and p64 K = 4 TAF steps at
    full width, TAF_WINDOWS windows each carrying state (two uniform, one
    skewed), after check_step_kernels: the kernels of each variant launch
    on every window, and its volume after the last is within VOLUME_TOL of
    the reference's (taf_reference; tests/test_bench_pipelines.py:100-105
    allows 2e-2). Device ms per window of each step, and of the step with
    the leaky volume where the step makes none. Returns the launch counts
    of each variant."""
    by_path = {}
    for sensor, e_per_bin in ((GEN1_SENSOR, E), (GEN4_SENSOR, E4)):
        w = device_windows(pipeline, np.random.default_rng(8), e_per_bin,
                           sensor, dev)
        windows = w[:TAF_WINDOWS - 1] + w[2:3]
        del w
        check_step_kernels(enc, windows, sensor, dev)
        refs = taf_reference(enc, pipeline, sensor, windows)
        for name, (state, step, volume, need) in taf_step_variants(
                enc, sensor).items():
            for fn in counters.values():
                fn.launches = 0
            for ev, nv in windows:
                state, vol = step(state, ev, nv)
            torch.cuda.synchronize()
            if volume is not None:
                vol = volume(state)
            launches = {k: fn.launches for k, fn in counters.items()}
            by_path[name] = launches
            if any(launches[k] < len(windows) for k in need):
                raise SystemExit(f"{name} did not launch {need} on every "
                                 f"window: {launches}")
            if not (torch.isfinite(state).all() and torch.isfinite(vol).all()):
                raise SystemExit(f"{name}: non-finite state or volume")
            ref = refs["p64" if "p64" in name else "folded"]
            err = (vol.float() - ref.float()).abs().max().item()
            if vol.shape != ref.shape or err > VOLUME_TOL:
                raise SystemExit(f"{name}: volume {tuple(vol.shape)} "
                                 f"{err:.3e} from the reference "
                                 f"{tuple(ref.shape)}")
            ev, nv = windows[0]
            ms = time_ms(lambda: step(state, ev, nv), n=5)
            with_vol = ""
            if volume is not None:
                vol_ms = time_ms(lambda: volume(step(state, ev, nv)[0]), n=5)
                with_vol = f" ({vol_ms:.3f} with the leaky volume, torch ops)"
            log(f"{name} on {card}: {ms:.3f} ms a {B}-stream window"
                f"{with_vol}, volume within {err:.2e} of the reference, "
                f"launches " + ", ".join(f"{k} {launches[k]}"
                                         for k in (B1, B2, B6)))
            del state, vol
            torch.cuda.empty_cache()
        del refs, windows
        torch.cuda.empty_cache()
    return by_path


# bench.py:59-99: (sensor, input, events a bin, classes, stem, factory,
# scatter, p64_input, kernels that must launch on every window)
SERVING_CONFIGS = {
    "gen1_taf_dense": (GEN1_SENSOR, GEN1_INPUT, E, 2, "bfm", "unpacked",
                       "mxu", False, (B6,)),
    "gen1_taf_p64": (GEN1_SENSOR, GEN1_INPUT, E, 2, "bfm_p64", "unpacked",
                     "mxu", True, (B6,)),
    "gen1_taf_packed": (GEN1_SENSOR, GEN1_INPUT, E, 2, "bfm", "packed",
                        "pallas", False, (B1,)),
    "gen4_taf_packed": (GEN4_SENSOR, GEN4_SENSOR, E4, 7, "bfm", "packed",
                        "pallas", False, (B1,)),
    "gen4_taf_xla": (GEN4_SENSOR, GEN4_SENSOR, E4, 7, "bfm", "unpacked",
                     "sorted", False, ()),
}


def run_serving_configs(pipeline, counters, dev, card):
    """Phase 25: the five serving configs of bench.py built on the
    unpacked and packed steps, at their shapes and widths (B = 128, AED
    256 wide, bf16, seeded random weights with raised obj biases) through
    pipeline.make_pipeline / make_pipeline_packed: SERVING_WINDOWS windows
    carrying state, every output finite, the kernels of each config on
    every window; per-stage device ms, windows/s (host clock, 5 steps) and
    peak memory. Returns the launch counts of each config."""
    from frlw_evd_tpu_torch.models import build_detector

    by_path = {}
    for name, (sensor, inp, e_per_bin, classes, stem, factory, scatter,
               p64_input, need) in SERVING_CONFIGS.items():
        torch.cuda.reset_peak_memory_stats()
        model = build_detector(classes, stem=stem,
                               generator=torch.Generator().manual_seed(0))
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        if factory == "unpacked":
            run = pipeline.make_pipeline(model, sensor, inp, scatter,
                                         p64_input=p64_input, device=dev)
        else:
            run = pipeline.make_pipeline_packed(model, sensor, inp, scatter,
                                                device=dev)
        state = pipeline.new_stream_state(B, sensor, factory, device=dev)
        windows = device_windows(pipeline, np.random.default_rng(10),
                                 e_per_bin, sensor, dev)[:SERVING_WINDOWS]
        encode, detect = run.stages["encode_transform"], run.stages["detect"]
        want = ((B, inp[0] // 2, inp[1] // 2, 8 * K) if p64_input
                else (B, *inp, 2 * K))
        for fn in counters.values():
            fn.launches = 0
        for i, (ev, nv) in enumerate(windows):
            state, vol = encode(state, ev, nv)
            dets, keep = detect(vol)
            torch.cuda.synchronize()
            if not (torch.isfinite(state).all() and torch.isfinite(vol).all()
                    and torch.isfinite(dets).all()):
                raise SystemExit(f"{name} window {i}: non-finite output")
            if vol.shape != want or dets.shape != (B, 100, 6):
                raise SystemExit(f"{name} window {i}: shapes {vol.shape}, "
                                 f"{dets.shape}")
            log(f"{name} window {i}: kept {int(keep.sum().item())} of "
                f"{int((dets[..., 5] > 0).sum().item())} boxes past conf "
                f"0.3 over {B} streams")
        launches = {k: fn.launches for k, fn in counters.items()}
        by_path[name] = launches
        if any(launches[k] < len(windows) for k in need):
            raise SystemExit(f"{name} did not launch {need} on every "
                             f"window: {launches}")
        ev, nv = windows[0]
        enc_ms = time_ms(lambda: encode(state, ev, nv), n=5)
        det_ms = time_ms(lambda: detect(vol), n=3)
        n = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            state, _ = run(state, *windows[i % len(windows)])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        log(f"{name} on {card}: encode_transform {enc_ms:.3f} ms, detect "
            f"{det_ms:.3f} ms per {B}-stream window batch; run_step "
            f"{step_s * 1e3:.3f} ms = {B / step_s:.1f} windows/s; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches " + ", ".join(f"{k} {launches[k]}"
                                     for k in (B1, B2, B6)))
        del model, run, state, windows, vol, dets, keep
        torch.cuda.empty_cache()
    return by_path


# bench.py:128-145: config → (encoder, sae_impl)
ENCODER_CONFIGS = {"gen1_eci": ("eci", "sorted"),
                   "gen1_sae": ("sae", "sorted"),
                   "gen1_sae_max": ("sae", "max"),
                   "gen1_ev": ("ev", "sorted"),
                   "gen1_frame": ("frame", "sorted")}


def run_encoder_configs(pipeline, counters, dev, card):
    """Phase 26: the five streaming encoder configs at GEN1 (B = 128,
    E = 16384) through pipeline.make_encoder_step, as run_encoder_bench
    runs them (bench.py:567-640): ENCODER_WINDOWS uniform windows with µs
    timestamps, both signatures warmed (state None, then carried), then
    ENCODER_REPEATS runs of ENCODER_STEPS windows, each ending in a host
    read: windows/s, Mev/s and ms a window of the median run on the host
    clock with the runs' spread, and the device ms of one window; no kernel
    launches. The sae sorted and max impls agree within rtol 1e-3,
    atol 1e-2 on one window with its timestamps sorted within each stream
    (tests/test_streaming_red.py:263-271).
    Returns the launch counts of each config."""
    ev, nv = pipeline.synth_events(np.random.default_rng(0), ENCODER_WINDOWS,
                                   B, E, GEN1_SENSOR)
    ev = torch.from_numpy(pipeline.encoder_events(ev)).to(dev)
    nv_host = nv
    nv = torch.from_numpy(nv).to(dev)
    fence = lambda a: float(a.reshape(-1)[0].item())
    # the impls agree where each stream's timestamps are monotone, as the
    # reference's are (max == last write); bench.py's synthetic t is not
    # sorted, so the comparison window sorts it
    ordered = ev[3].clone()
    ordered[..., 2] = ordered[..., 2].sort(dim=1).values
    by_path, sae_out = {}, {}
    for name, (kind, impl) in ENCODER_CONFIGS.items():
        step = pipeline.make_encoder_step(kind, GEN1_SENSOR, sae_impl=impl,
                                          device=dev)
        for fn in counters.values():
            fn.launches = 0
        out, state = step(None, ev[0], nv[0], 10000.0)
        fence(out)
        if state is not None:
            out, state = step(state, ev[0], nv[0], 10000.0)
            fence(out)
        runs = []
        for _ in range(ENCODER_REPEATS):
            t0 = time.perf_counter()
            for i in range(ENCODER_STEPS):
                s = i % ENCODER_WINDOWS
                out, state = step(state, ev[s], nv[s], (s + 1) * 10000.0)
            fence(out)
            runs.append(time.perf_counter() - t0)
        elapsed = sorted(runs)[ENCODER_REPEATS // 2]
        spread = (max(runs) - min(runs)) / elapsed
        by_path[name] = {k: fn.launches for k, fn in counters.items()}
        if not torch.isfinite(out).all():
            raise SystemExit(f"{name}: non-finite output")
        dev_ms = time_ms(lambda: step(state, ev[0], nv[0], 10000.0), n=5)
        events = sum(int(nv_host[i % ENCODER_WINDOWS].sum())
                     for i in range(ENCODER_STEPS))
        log(f"{name} on {card}: {ENCODER_STEPS * B / elapsed:.1f} "
            f"windows/s, {events / elapsed / 1e6:.1f} Mev/s, "
            f"{elapsed / ENCODER_STEPS * 1e3:.3f} ms per {B}-stream window "
            f"(host clock, the median of {ENCODER_REPEATS} runs, which "
            f"spread by {spread:.0%} of it); device {dev_ms:.3f} ms a "
            f"window; output {tuple(out.shape)}")
        if kind == "sae":
            sae_out[impl] = step(None, ordered, nv[3], 40000.0)[0]
    err = (sae_out["max"] - sae_out["sorted"]).abs()
    bound = 1e-2 + 1e-3 * sae_out["sorted"].abs()
    if bool((err > bound).any()):
        raise SystemExit(f"sae max and sorted differ by up to "
                         f"{err.max().item():.3e}")
    log(f"sae max against sorted: max |d| {err.max().item():.3e} "
        f"(rtol 1e-3, atol 1e-2)")
    if any(any(c.values()) for c in by_path.values()):
        raise SystemExit(f"an encoder config launched a kernel: {by_path}")
    return by_path


def small_new_encode_outputs(enc, pipeline, d):
    """Phase 27's functions on device d at a small size, each a tuple of
    outputs on the CPU: name → (outputs, atol, rtol)."""
    from frlw_evd_tpu_torch.models import build_detector

    st = enc.streaming
    rng = np.random.default_rng(11)
    H, W = 60, 72
    ev_n, nv_n = pipeline.synth_events_skewed(rng, 3, 2, 1024, (H, W))
    win = [(torch.from_numpy(ev_n[i]).to(d), torch.from_numpy(nv_n[i]).to(d))
           for i in range(3)]
    us = [(torch.from_numpy(e).to(d), n) for e, (_, n) in
          zip(pipeline.encoder_events(ev_n), win)]
    idx = torch.from_numpy(rng.integers(-50, 5050, (2, 3000))).int().to(d)
    tv = torch.from_numpy(rng.uniform(-1, 0, (2, 3000))).float().to(d)
    valid = torch.from_numpy(rng.random((2, 3000)) < 0.9).to(d)
    cpu = lambda *ts: tuple(t.float().cpu() for t in ts)
    out = {}
    out["scatter_add_mxu"] = (cpu(enc.scatter_add_mxu(idx, tv * 7.0, 5000)),
                              1e-4, 0)
    for precise in (True, False):
        out[f"scatter_cnt_tsum_mxu precise={precise}"] = (cpu(
            *enc.scatter_cnt_tsum_mxu(idx, tv, valid, 5000, precise)),
            1e-4, 0)
    out["segment_last_sorted"] = (cpu(*enc.segment_last_sorted(
        idx, tv * 100.0, valid, 5000)), 2e-2, 2e-4)

    def carry(state, step, tol, rtol=0.0):
        for ev, nv in win:
            state = step(state, ev, nv)
        return (cpu(*(state if isinstance(state, tuple) else (state,))),
                tol, rtol)

    unpacked = torch.full((2, H, W, 2, K), -6000.0, device=d)
    for kw in (dict(use_mxu=True), dict(use_sorted=True),
               dict(use_mxu=False)):
        out[f"taf_stream_step {kw}"] = carry(
            unpacked.clone(), lambda s, e, n: st.taf_stream_step(
                s, e, n, precise=False, **kw), 2e-3)
    packed = torch.full((2, H, W, 2 * K), -6000.0, device=d)
    for sc, pr in (("pallas", False), ("pallas", True), ("sorted", False),
                   ("mxu", False), ("xla", False)):
        out[f"taf_stream_step_packed {sc} precise={pr}"] = carry(
            packed.clone(), lambda s, e, n: st.taf_stream_step_packed(
                s, e, n, scatter=sc, precise=pr), 2e-3)
    for sc in ("pallas", "sorted"):
        out[f"taf_stream_step_folded {sc}"] = carry(
            enc.init_state(2, H, W, K, device=d),
            lambda s, e, n: st.taf_stream_step_folded(
                s, e, n, height=H, width=W, scatter=sc), 5e-3)
    # the p64 K = 4 step at 60x72: (W/2) = 36, which K = 4 takes
    for sc, pr in (("pallas", False), ("pallas", True), ("sorted", False)):
        out[f"taf_stream_step_kernel_p64 K=4 {sc} precise={pr}"] = carry(
            enc.p64_init_state(2, H, W, K=4, device=d),
            lambda s, e, n: enc.taf_stream_step_kernel_p64(
                s if not isinstance(s, tuple) else s[0], e, n, height=H,
                width=W, scatter=sc, precise=pr), 1e-2)
    for use_mxu in (True, False):
        state = None
        for i, (ev, nv) in enumerate(us):
            vol, state = st.event_volume_stream(
                ev, nv, state, (i + 1) * 10000.0, height=H, width=W,
                use_mxu=use_mxu)
        out[f"event_volume_stream use_mxu={use_mxu}"] = (
            cpu(vol, state.volume), 2e-2, 0)
    out["event_frame_stream"] = (cpu(st.event_frame_stream(
        *win[0], None, height=H, width=W)[0]), 0.0, 0)
    for impl in ("sorted", "max"):
        mem = None
        for i, (ev, nv) in enumerate(us):
            sae, mem = st.sae_stream(ev, nv, mem, (i + 1) * 10000.0,
                                     height=H, width=W, impl=impl)
        out[f"sae_stream {impl}"] = (cpu(sae, mem), 1e-3, 1e-4)
    ev, nv = win[0]
    out["encode_count_image_batch"] = (cpu(enc.encode_count_image_batch(
        ev, nv, height=H, width=W)), 1e-3, 0)
    out["encode_event_volume_batch"] = (cpu(enc.encode_event_volume_batch(
        ev, nv, height=H, width=W)), 2e-3, 0)
    ev_us, _ = us[0]
    mem0 = enc.sae_init_state(H, W, now=10000.0, device=d).expand(2, H, W, 2)
    out["encode_sae_batch"] = (cpu(*enc.encode_sae_batch(
        ev_us, nv, mem0, 10000.0, height=H, width=W)), 1e-3, 1e-4)
    state = enc.taf_init_state(H, W, K, device=d)
    state = enc.encode_taf_window(state, ev, nv)
    out["encode_taf_window"] = (cpu(state), 2e-3, 0)
    out["taf_state_to_volume"] = (cpu(enc.taf_state_to_volume(state)),
                                  2e-3 * 255 / 8.7, 0)
    model = build_detector(2, stem="bfm", in_channels=(32, 32, 32),
                           stem_out_channels=16, head_width=32)
    for factory, sc in (("unpacked", "mxu"), ("packed", "pallas")):
        make = (pipeline.make_pipeline if factory == "unpacked"
                else pipeline.make_pipeline_packed)
        run = make(model, (H, W), (64, 96), sc, device=d,
                   dtype=torch.float32)
        state = pipeline.new_stream_state(2, (H, W), factory, device=d)
        for ev, nv in win:
            state, vol = run.stages["encode_transform"](state, ev, nv)
        out[f"make_pipeline {factory} {sc} encode_transform"] = (
            cpu(state, vol), 2e-2, 0)
    return out


def check_new_encode_against_cpu(enc, pipeline, dev):
    """Phase 27: every function this slice added, at a small size (60x72,
    2 streams, 1024 skewed events; the histograms on 3000 random cells),
    once on the card and once on the CPU, within the tolerances of the CPU
    tests against JAX (tests/test_torch_port_streaming.py,
    tests/test_torch_port_encoders.py, tests/test_torch_port_p64.py)."""
    got = small_new_encode_outputs(enc, pipeline, dev)
    want = small_new_encode_outputs(enc, pipeline, "cpu")
    for name, (outs, atol, rtol) in got.items():
        worst = 0.0
        for g, w in zip(outs, want[name][0]):
            d = (g - w).abs()
            if g.shape != w.shape or bool((d > atol + rtol * w.abs()).any()):
                raise SystemExit(f"{name}: card against CPU beyond atol "
                                 f"{atol}, rtol {rtol}: max |d| "
                                 f"{d.max().item():.3e}")
            worst = max(worst, d.max().item())
        log(f"small {name}: card vs CPU max |d| {worst:.2e} (atol {atol}, "
            f"rtol {rtol})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from frlw_evd_tpu_torch import encode as enc
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.kernels import _build
    from frlw_evd_tpu_torch.models import quantize, stem_chain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    counters = {"scatter_cnt_tsum": enc.scatter_cnt_tsum,
                "scatter_cnt_tsum_pallas_sorted":
                    enc.scatter_cnt_tsum_pallas_sorted,
                "scatter_cnt_tsum_pallas": enc.scatter_cnt_tsum_pallas,
                "taf_update_leaky": enc.taf_update_leaky,
                "taf_update_leaky_raw": enc.taf_update_leaky_raw,
                "taf_update_leaky_v2": enc.taf_update_leaky_v2,
                "bfm_chain_apply_folded": stem_chain.bfm_chain_apply_folded,
                "bfm_chain_apply": stem_chain.bfm_chain_apply,
                "int8_conv2d": quantize.int8_conv2d}

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    log(f"phase 1 (build): {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    windows = device_windows(pipeline, rng, E, GEN1_SENSOR, dev)
    ev_sets = {"uniform": windows[0], "skewed": windows[2]}
    rows = {"scatter_cnt_tsum": phase(2, "B1 folded", check_scatter, enc,
                                      ev_sets, dev, rate, GEN1_SENSOR,
                                      "folded"),
            "taf_update_leaky": phase(3, "B2", check_update, enc, ev_sets,
                                      dev, rate)}
    by_path = {"gen1": phase(4, "GEN1 path", run_main_path, pipeline,
                             counters, windows[:MAIN_WINDOWS], dev, card)}
    phase(5, "GEN1 small, card vs CPU", check_small_against_cpu, pipeline,
          dev)
    gen1_sets = ev_sets
    del windows

    windows = device_windows(pipeline, rng, E4, GEN4_SENSOR, dev)
    ev_sets = {"uniform": windows[0], "skewed": windows[2]}
    rows["scatter_cnt_tsum_p64"] = phase(6, "B1 p64", check_scatter, enc,
                                         ev_sets, dev, rate, GEN4_SENSOR,
                                         "p64")
    rows["taf_update_leaky_raw"] = phase(7, "B3", check_update_raw, enc,
                                         ev_sets, dev, rate)
    torch.cuda.empty_cache()
    rows.update(phase(8, "B4 and B7", check_chains, stem_chain, dev, name))
    torch.cuda.empty_cache()
    by_path["gen4"] = phase(9, "gen4 path", run_gen4_path, pipeline,
                            counters, windows, dev, card)
    torch.cuda.empty_cache()
    by_path["gen4_bfm_p64_kernel"] = phase(
        10, "bfm_p64_kernel stem", run_p64_kernel_config, pipeline, counters,
        windows[:3], dev)
    phase(11, "gen4 small, card vs CPU", check_small_p64_against_cpu,
          pipeline, dev)
    torch.cuda.empty_cache()

    rows["scatter_cnt_tsum_pallas_sorted"] = phase(12, "B6", check_pair_sorted,
                                                   enc, ev_sets, rate)
    torch.cuda.empty_cache()
    rows["taf_update_leaky_v2"] = phase(13, "B5", check_update_v2, enc,
                                        ev_sets, dev, rate)
    torch.cuda.empty_cache()
    rows["scatter_cnt_tsum_pallas"], by_path["gen1_b8"] = phase(
        14, "B8", check_dense, enc, counters, gen1_sets, rate)
    del gen1_sets
    torch.cuda.empty_cache()
    by_path.update(phase(15, "gen4 sorted and precise paths",
                         run_precise_sorted_paths, pipeline, enc, counters,
                         windows[:3], dev, card))
    phase(16, "precise and sorted steps small, card vs CPU",
          check_small_steps_against_cpu, enc, pipeline, dev)
    del windows, ev_sets
    torch.cuda.empty_cache()

    from frlw_evd_tpu_torch import train
    from frlw_evd_tpu_torch.models import build_detector
    for n, config in ((17, "gen1_train"), (18, "gen4_train")):
        phase(n, config, run_train_config, train, build_detector, counters,
              config, dev, card, name)
        torch.cuda.empty_cache()
    phase(19, "small train step, card vs CPU", check_small_train_against_cpu,
          train, build_detector, dev)
    phase(20, "B1 and B6 at E = 2^19", check_long_streams, enc, pipeline,
          dev, rate)
    torch.cuda.empty_cache()
    rows["int8_conv2d"] = phase(21, "int8_conv2d", check_int8_conv, quantize,
                                build_detector, pipeline, rate, name)
    windows = (device_windows(pipeline, np.random.default_rng(3), E,
                              GEN1_SENSOR, dev)
               + device_windows(pipeline, np.random.default_rng(4), E,
                                GEN1_SENSOR, dev))
    by_path["gen1_int8"] = phase(22, "GEN1 int8 path", run_gen1_int8_path,
                                 pipeline, quantize, build_detector,
                                 counters, windows, dev, card)
    del windows
    torch.cuda.empty_cache()
    windows = (device_windows(pipeline, np.random.default_rng(5), E4,
                              GEN4_SENSOR, dev)
               + device_windows(pipeline, np.random.default_rng(6), E4,
                                GEN4_SENSOR, dev))
    by_path["gen4_int8"] = phase(23, "gen4 int8 path", run_gen4_int8_path,
                                 pipeline, quantize, build_detector,
                                 counters, windows, dev, card)
    del windows
    torch.cuda.empty_cache()
    by_path.update(phase(24, "TAF steps", run_taf_steps, enc, pipeline,
                         counters, dev, card))
    by_path.update(phase(25, "serving configs", run_serving_configs,
                         pipeline, counters, dev, card))
    by_path.update(phase(26, "encoder configs", run_encoder_configs,
                         pipeline, counters, dev, card))
    phase(27, "new encode functions small, card vs CPU",
          check_new_encode_against_cpu, enc, pipeline, dev)

    # entry: (wrapper, paths that launch it in the entry's cell order (B1)
    # or at all, the first being the one at the entry's shape whose
    # launches the entry reports, source, TPU kernel)
    meta = {
        "scatter_cnt_tsum": ("scatter_cnt_tsum",
                             ("gen1", "gen1_int8", "gen1_packed_pallas",
                              "gen4_packed_pallas", "gen4_folded_pallas",
                              "gen1_taf_packed", "gen4_taf_packed"),
                             "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                             "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "scatter_cnt_tsum_p64": ("scatter_cnt_tsum",
                                 ("gen4", "gen4_bfm_p64_kernel",
                                  "gen4_int8", "gen4_p64k4_raw"),
                                 "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                                 "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "scatter_cnt_tsum_pallas_sorted": (
            "scatter_cnt_tsum_pallas_sorted",
            ("gen4_precise", "gen4_p64k4_precise", "gen1_unpacked_mxu",
             "gen1_packed_precise", "gen1_packed_mxu", "gen1_taf_dense",
             "gen1_taf_p64"),
            "frlw_evd_tpu_torch/csrc/scatter_sorted.cu",
            "frlw_evd_tpu/encode/pallas_scatter.py:343"),
        "scatter_cnt_tsum_pallas": ("scatter_cnt_tsum_pallas", ("gen1_b8",),
                                    "frlw_evd_tpu_torch/csrc/scatter_dense.cu",
                                    "frlw_evd_tpu/encode/pallas_scatter.py:67"),
        "taf_update_leaky": ("taf_update_leaky",
                             ("gen1", "gen1_int8", "gen4_folded_pallas",
                              "gen4_folded_sorted", "gen4_p64k4_raw",
                              "gen4_p64k4_precise", "gen4_p64k4_sorted"),
                             "frlw_evd_tpu_torch/csrc/taf_update.cu",
                             "frlw_evd_tpu/encode/pallas_update.py:37"),
        "taf_update_leaky_raw": ("taf_update_leaky_raw",
                                 ("gen4", "gen4_bfm_p64_kernel",
                                  "gen4_int8"),
                                 "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                 "frlw_evd_tpu/encode/pallas_update.py:233"),
        "taf_update_leaky_v2": ("taf_update_leaky_v2",
                                ("gen4_sorted", "gen4_precise"),
                                "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                "frlw_evd_tpu/encode/pallas_update.py:143"),
        "bfm_chain_apply_folded": ("bfm_chain_apply_folded",
                                   ("gen4", "gen4_sorted", "gen4_precise",
                                    "gen4_int8"),
                                   "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                                   "frlw_evd_tpu/models/pallas_stem.py:98"),
        "bfm_chain_apply": ("bfm_chain_apply", ("gen4_bfm_p64_kernel",),
                            "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                            "frlw_evd_tpu/models/pallas_stem.py:59"),
        "int8_conv2d": ("int8_conv2d", ("gen1_int8", "gen4_int8"),
                        "frlw_evd_tpu_torch/csrc/int8_conv.cu",
                        "none (XLA conv, frlw_evd_tpu/models/quantize.py:283)"),
    }
    for wrapper in counters:          # every launching path is listed
        listed = {p for w, paths, _, _ in meta.values() if w == wrapper
                  for p in paths}
        seen = {p for p, counts in by_path.items() if counts[wrapper]}
        if seen != listed:
            raise SystemExit(f"{wrapper}: launched on {sorted(seen)}, "
                             f"listed for {sorted(listed)}")
    kernels = []
    for entry, row in rows.items():
        wrapper, paths, source, replaces = meta[entry]
        kernels.append({"name": entry, "route": "cuda", "source": source,
                        "replaces": replaces, "path": paths[0],
                        "launches": by_path[paths[0]][wrapper],
                        "launches_by_path": {p: by_path[p][wrapper]
                                             for p in paths},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        **{k: row[k] for k in ("ms_by_set",
                                               "library_ms_by_set",
                                               "per_block_tiles_ms",
                                               "split_ms", "tilings_ms",
                                               "cudnn_bf16_ms",
                                               "ms_1x1", "int_mm_1x1_ms",
                                               "by_site", "map_host_us",
                                               "gen4")
                           if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
