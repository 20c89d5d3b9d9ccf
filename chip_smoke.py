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
     input, card against CPU, at the CPU tests' tolerances;
 28. the data path at full GEN1 width under build/chip_smoke: a synthetic
     tree (data/synthetic: 8 train and 2 val streams of 2 s, 24
     annotation times 40 ms apart), tools.generate_taf on the card and
     (val) on the CPU, the val blobs card against CPU and each against
     the oracle's (share of bytes off by more than one below 1e-3), then
     Trainer.train() of taf_bfm / gen1 (AED 256 wide, bfm stem, batch 64,
     bf16 over f32 masters) for 2 epochs with validation each epoch:
     every loss and COCO stat finite, last_epoch and best_epoch written,
     no kernel launched; one more epoch under torch.profiler; then
     `python -m frlw_evd_tpu_torch.cli.test --resume_exp` in a
     subprocess on the val split, its stats equal to the in-process
     validation of best_epoch within 1e-6; ms/step, the share of it the
     loop waits for the loader, the device's busy share, the evaluator's
     seconds, the generator's ms a blob, beside phase 17's gen1_train;
 29. tools.stream_infer over one 2 s recording of that tree at batch 1,
     f32, AED 256 wide: first B6 at B = 1, E = 16384 on the cells of
     every window against its twin bit for bit, timed; 5 windows through
     the tool's command line with phase 28's best_epoch; then 200
     windows with phase 4's weights: B6 launched once every window,
     detections finite, the -out npz in the JAX tool's layout;
     windows/s, window latency p50 / p99 (host clock);
 30. card against CPU, small, f32 with TF32 off: one Trainer epoch of a
     narrow taf_bfm AED on a 120x152 tree (losses rtol 2e-4, BatchNorm
     statistics 1e-5), its eval_epoch (detections by DET_GATES, COCO
     stats within 1e-3) and 20 windows of stream_infer at 60x76;
 31. tools.generate_eventvolume, generate_eventcountimage and
     generate_surfaceofactiveevents at full GEN1 geometry over phase 28's
     tree, on the card every split, on the CPU the first val stream: that
     stream's blobs card against CPU and each against the oracle's
     (oracle_generator_blobs), share of bytes off by more than one below
     1e-3; ms an encode on each device; no kernel launched;
 32. Trainer.train() at batch 64, full GEN1 width, one epoch with
     validation: `basic` (aed, focus, 10 channels) on phase 31's EV blobs
     and `yolox_taf_bfm` (CSPDarknet, bfm) on phase 28's TAF blobs, held
     and printed as phases 35 and 36;
 33. gen1_train at batch 64 four ways (plain, remat, p64, both): one f32
     step (TF32 off) from the same weights, batch and dropout seed, remat
     against plain and remat_p64 against p64 with dropout on, p64 against
     plain with dropout 0: losses within rtol 2e-4, BatchNorm statistics
     within 1e-5; then each way through train.run_train (bf16, dropout
     on): ms/step, peak memory, MFU; no kernel launched;
 34. a yolox_taf_bfm model (CSPDarknet, bfm stem, 2 classes, bf16) served
     through make_pipeline_kernel at GEN1, B = 128, E = 16384, as phase 4
     (B1 and B2 on every window; windows/s, encode_transform and detect
     ms), then phase 5's card-against-CPU check with a small yolox model;
 35. Trainer.train() of `yolov3_taf_bfm` (Darknet-53, BFM stem, the
     YOLOv3 FPN and anchor head, gt_creator's targets) at the config's
     640x640 with clipping over phase 28's tree, its TAF blobs generated
     on the card at 640x640, batch 64 (halved until it fits), bf16 over
     f32 masters, one epoch with validation;
 36. Trainer.train() of `red`, `convlstm` and `recconv` on phase 31's EV
     blobs at GEN1 256x320, batch 64, the config's widths (in_channels
     256), one epoch with validation. 35 and 36: at least 3 steps, every
     loss and COCO stat finite, best_epoch written, no kernel launched;
     ms/step, the loader-wait share (and gt_creator's host seconds),
     peak memory, FLOPs of a step counted as phase 17 counts them, MFU;
     then Trainer.test() on best_epoch, its stats within 1e-6 of the
     epoch's validation;
 37. card against CPU, small, f32 with TF32 off: one train step of each
     of the five exp types through its Trainer's steps from the same
     seeded weights (dropout 0) and batch: the eval step's decoded rows
     of every level before NMS and its detections after it by DET_GATES,
     losses within rtol 2e-4, BatchNorm statistics within 1e-5 (the
     yolov3 families' within 1e-5 of max(|value|, 1)); then one bf16 red
     step on the card, its losses finite;
 38. GEN1 serving with the merged head (head_merged) through
     make_pipeline_kernel, B = 128, E = 16384, phase 22's AED: bf16 maps
     within relative L2 1e-3 of the canonical head's on the same weights
     (and a planted BatchNorm slice fault beyond it);
     int8 calibrated on the merged model (the canonical site keys), the
     towers served as one Cout-512 site and one site a group a level
     (int8_conv2d launched 58 times a window where the canonical path
     launches 61), every site within relative L2 0.04 of its bf16 conv,
     each merged launch bit for bit its twin, head maps within 0.08;
     windows/s of both heads in turns, bf16 and int8; then the `taf` stem
     served as phase 4 (B1 and B2 on every window);
 39. Trainer.train() of taf_swin, taf_corr and taf_syn on phase 28's TAF
     blobs, batch 64 (halved until it fits), held and printed as phases
     35 and 36; then gen1_train with the merged and the canonical head in
     turns through train.run_train: ms/step, peak memory, no kernel;
 40. card against CPU, small, f32 with TF32 off: phase 37's check of
     taf_swin, taf_corr and taf_syn; phase 19's train-step check of the
     small AED with the taf stem, the taf_3d stem and the merged head;
     MBV2CA's logits and one train step;
 41. parallel/spatial.py at full width, 4 row shards run one after
     another on the card: the gen4 p64 step (B = 128, E = 65536, K = 8)
     raw (B1 in the p64 order, then B3) and sorted (then B5) over three
     windows (one with events in shard 0's rows only, one empty), each
     shard's state and folded volume bit for bit the unsharded step's
     rows, B1 and B3 or B5 launched 4 times a window; the GEN1 step
     (B = 128, E = 16384) with B6 and the 2-D layout (2 batch halves x
     2 row shards), likewise; device ms of the shards and the unsharded
     step;
 42. data-parallel training: gen1_train through run_train at world size
     1 under NCCL in a subprocess with torchrun's environment (ms/step
     beside phase 17's); one Adam step of gen1_train's AED at world size
     2 over gloo on the one card (32 rows a rank) against world size 1 on
     the 64 rows (f32 losses rtol 2e-4 and statistics 1e-5; in f64 the
     parameters 1e-5 and the gradients 1e-6);
     cli.train at world size 2 over gloo for one Trainer epoch of
     taf_bfm on phase 28's blobs (the checkpoint, finite COCO stats, no
     kernel launched);
 43. tools/export_model.py in a subprocess on phase 22's AED saved as a
     checkpoint (the full-width GEN1 AED, B = 128), bf16 and --fuse
     --int8, each with --check; each .pt2 loaded here and held to the live step built the
     same way (keep equal, dets within 1e-5), int8_conv2d launched 61
     times a call of the int8 program; windows/s of the loaded program
     and the live step in turns.
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

import ast
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
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


def run_main_path(pipeline, counters, windows, dev, card, model=None,
                  label="main path"):
    """Phase 4: the GEN1 serving path at full width (phase 34: with the
    yolox `model`); returns the launch counts of its run."""
    from frlw_evd_tpu_torch.models import build_detector

    if model is None:
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
            raise SystemExit(f"{label} window {i}: non-finite output")
        if vol.shape != (B, *GEN1_INPUT, 2 * K) or dets.shape != (B, 100, 6):
            raise SystemExit(f"{label} window {i}: shapes {vol.shape}, "
                             f"{dets.shape}")
        n_valid_rows = int((dets[..., 5] > 0).sum().item())
        log(f"{label} window {i}: kept {int(keep.sum().item())} of "
            f"{n_valid_rows} boxes past conf 0.3 over {B} streams")
    launches = {k: fn.launches for k, fn in counters.items()}
    if min(launches[k] for k in ("scatter_cnt_tsum",
                                 "taf_update_leaky")) < len(windows):
        raise SystemExit(f"{label} did not go through the kernels: "
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
    log(f"{label} on {card}: encode_transform {enc_ms:.3f} ms, detect "
        f"{det_ms:.3f} ms per {B}-stream window batch; run_step "
        f"{step_s * 1e3:.3f} ms = {B / step_s:.1f} windows/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def check_small_against_cpu(pipeline, dev, family="aed"):
    """Phase 5: the slice on the card vs on the CPU, 60x72 → 64x96, f32
    (phase 34: a yolox model with its head 32 wide)."""
    from frlw_evd_tpu_torch.models import build_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sensor, inp = (60, 72), (64, 96)
    widths = (dict(in_channels=(32, 32, 32), stem_out_channels=16)
              if family == "aed" else {})
    runs, states = {}, {}
    for d in ("cpu", dev):
        model = build_detector(2, family=family, stem="bfm", head_width=32,
                               **widths)
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
            raise SystemExit(f"small {family} window {i}: state err "
                             f"{st_err}, "
                             f"vol err {vol_err}, keep masks equal: "
                             f"{same_keep}, dets finite: "
                             f"{bool(torch.isfinite(g_dets).all())}")
        log(f"small {family} window {i}: card vs CPU state err "
            f"{st_err:.2e}, "
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


LAMDAS = (0.00001, 0.0000025, 0.000001)    # the SAE generator's
SMALL_TRAIN_GATES = {"losses": 2e-4, "statistics": 1e-5, "gradients": 1e-6,
                     "parameters": 1e-6, "residue": 1e-12}
# a reference gradient leaf below this share of the largest leaf's
# magnitude is 0 in exact arithmetic (small_train_errors)
GRAD_FLOOR = 1e-12
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


def small_sgd_step(train, build_detector, device, dtype, imgs, labels,
                   **build_kw):
    """One SGD(1e-2) step of the seeded small AED (32 wide, stem bfm or
    build_kw's, every dropout 0) in `dtype` on `device`: (losses,
    gradients, float state after), as f64 on the CPU."""
    from frlw_evd_tpu_torch.models.blocks import Dropout

    model = build_detector(2, **{"stem": "bfm", **build_kw}, train=True,
                           dropout_rate=0.0,
                           generator=torch.Generator().manual_seed(0),
                           in_channels=(32, 32, 32), stem_out_channels=16,
                           head_width=32)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    if dtype == torch.float32:
        state = train.create_train_state(model, train.sgd(1e-2),
                                         device=device)
    else:
        model.to(device, dtype)
        state = train.TrainState(
            0, model, train.sgd(1e-2).make(model.named_parameters()))
    step = train.make_train_step((8, 16, 32), 2, 2.5, device=device)
    losses = step(state, torch.from_numpy(imgs).to(dtype),
                  torch.from_numpy(labels), torch.Generator(device=device))
    return ({k: v.item() for k, v in losses.items()},
            {k: p.grad.double().cpu() for k, p in model.named_parameters()},
            {k: v.double().cpu() for k, v in model.state_dict().items()
             if v.is_floating_point()})


def small_train_errors(train, build_detector, dev, **build_kw) -> dict:
    """small_sgd_step (of build_kw's model) on `dev` against the CPU, TF32
    off meanwhile: in f32 the losses' largest relative error and the
    running statistics' largest absolute error; with the network in f64
    the gradients' error over each leaf's largest magnitude, the
    parameters' absolute error after the step, and the "residue": the
    error of the leaves whose reference is below GRAD_FLOOR of the largest
    leaf, over the largest leaf's magnitude. Held to SMALL_TRAIN_GATES,
    the gates of tests/test_torch_port_train.py (the residue's is
    GRAD_FLOOR)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        imgs, labels = small_train_batch(np.random.default_rng(0))
        runs = {d: small_sgd_step(train, build_detector, d, torch.float32,
                                  imgs, labels, **build_kw)
                for d in ("cpu", dev)}
        err = {"losses": max(abs(runs[dev][0][k] / v - 1)
                             for k, v in runs["cpu"][0].items()),
               "statistics": max((runs[dev][2][k] - v).abs().max().item()
                                 for k, v in runs["cpu"][2].items()
                                 if k.endswith(STATS))}
        runs = {d: small_sgd_step(train, build_detector, d, torch.float64,
                                  imgs, labels, **build_kw)
                for d in ("cpu", dev)}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    # a leaf whose gradient is 0 in exact arithmetic (a conv bias that a
    # training-mode BatchNorm follows: taf_3d's BaseConvs) holds rounding
    # residue, 1e-15 of the largest leaf on the CPU, where the smallest
    # other leaf reads 8e-7 of it: no relative error is defined there
    top = max(g.abs().max().item() for g in runs["cpu"][1].values())
    err["gradients"], err["residue"] = 0.0, 0.0
    for k, g in runs["cpu"][1].items():
        m, diff = g.abs().max().item(), (runs[dev][1][k] - g).abs().max()
        if m > GRAD_FLOOR * top:
            err["gradients"] = max(err["gradients"], diff.item() / m)
        else:
            err["residue"] = max(err["residue"], diff.item() / top)
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
        f"{err['gradients']:.2e} of each leaf's largest (residue "
        f"{err['residue']:.2e} of the largest leaf's), parameters after "
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
        site = quantize.Int8Site(wq.permute(0, 3, 1, 2), scale, 1.0 / inv,
                                 s)
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
        del site
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


# phases 28-30 work under the checkout's build/ (gitignored), emptied first
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
# phase 28's GEN1 tree: 2 s streams of two moving boxes and noise (about
# 4500 events a 10 ms window), annotated every 40 ms from 0.6 s (the
# evaluation skips the first 0.5 s); 8 train streams x 24 annotation times
# = 3 steps an epoch at batch 64, 2 val streams
GEN1_TREE = dict(ann_times=tuple(600_000 + 40_000 * i for i in range(24)),
                 duration=2_000_000, sensor_hw=GEN1_SENSOR,
                 input_hw=GEN1_INPUT, events_per_box=400_000,
                 noise_events=100_000)
TRAIN_STREAMS, VAL_STREAMS, TREE_BATCH, TREE_EPOCHS = 8, 2, 64, 2
# tests/test_generators.py's gate: the share of blob bytes off by more than
# one below 1e-3 (f32 sums in another order may flip a uint8 boundary)
BLOB_GATE = 1e-3
STREAM_WINDOWS = 200
# card against CPU (phase 30), f32 with TF32 off: the kept rows the same, as
# phase 5 holds the keep masks, each box within box_atol + box_rtol * |box|
# (w and h are exp() of the head's output, so their error grows with
# them) and each score within `score`; the COCO stats within STATS_GATE
DET_GATES = {"box_atol": 1e-2, "box_rtol": 1e-4, "score": 1e-4}
STATS_GATE = 1e-3


def build_gen1_tree(root):
    """Phase 28's tree (GEN1_TREE) under root: the train split without
    oracle blobs, the val split with the oracle's TAF blobs."""
    from frlw_evd_tpu_torch.data import synthetic

    synthetic.build_mini_gen1(
        root, np.random.default_rng(10), splits=("train",), blobs=(),
        streams=tuple(f"train{i}" for i in range(TRAIN_STREAMS)),
        **GEN1_TREE)
    return synthetic.build_mini_gen1(
        root, np.random.default_rng(11), splits=("val",), blobs=("taf",),
        streams=tuple(f"val{i}" for i in range(VAL_STREAMS)), **GEN1_TREE)


GENERATORS = ("eventvolume", "eventcountimage", "surfaceofactiveevents")


def oracle_generator_blobs(tool: str, event_path: str, bbox_path: str,
                           sensor, target):
    """{blob file relative to the tool's target directory: uint8 blob}
    of one stream, as the port's generate_<tool> windows it (EV: the
    trailing 250 / 500 / 1000 ms; ECI: the last 5e4 / 1e5 / 2e5 events;
    SAE: the 5 s before the first annotation time, then the events since
    the last one, the memory carried), encoded by encode/oracle.py in
    numpy from the whole recording (dat_codec), the windows cut by
    searchsorted on its timestamps. GEN1 geometry: encoded at `sensor`,
    resized to `target`."""
    from frlw_evd_tpu_torch.encode import oracle
    from frlw_evd_tpu_torch.events.dat_codec import load_td_data
    from frlw_evd_tpu_torch.events.npy_codec import load_bboxes

    raw = load_td_data(event_path)
    t = raw["ts"].astype(np.int64)
    xytp = np.stack([raw["x"], raw["y"], t, raw["p"]], -1).astype(np.float64)
    name = Path(event_path).name[:-len("_td.dat")]
    split = Path(event_path).parent.name
    memory, prev_end, prev_ts = None, 0, -1e8
    out = {}
    for ts in np.unique(load_bboxes(bbox_path)["t"]):
        end = int(np.searchsorted(t, ts))
        blob = f"{split}/{name}_{ts}.npy"
        if tool == "eventvolume":
            for tw in (250000, 500000, 1000000):
                ev = xytp[end - int(np.sum(t[:end] > ts - tw)):end].copy()
                ev[:, 2] = (ev[:, 2] - (ts - tw)) / tw
                vol = oracle.event_volume(ev.astype(np.float32), sensor, 5)
                out[f"EventVolume{tw}/{blob}"] = oracle.to_uint8(
                    oracle.nearest_resize(vol, target))
        elif tool == "eventcountimage":
            for n in (50000, 100000, 200000):
                vol = oracle.count_image(
                    xytp[max(0, end - n):end].astype(np.float32), sensor)
                out[f"EventCountImage{n}/{blob}"] = oracle.to_uint8(
                    oracle.nearest_resize(vol, target), clip=False)
        else:
            start = ts - 5_000_000
            begin = prev_end if start <= prev_ts else (
                int(np.searchsorted(t, start)) if start >= 0 else 0)
            ecd, memory = oracle.sae(xytp[begin:end].astype(np.float32),
                                     sensor, LAMDAS, memory, float(ts))
            ecd = oracle.to_uint8(oracle.nearest_resize(ecd, target),
                                  clip=False)
            for j, lam in enumerate(LAMDAS):
                out[f"SurfaceOfActiveEvents{lam}/{blob}"] = \
                    ecd[2 * j:2 * j + 2]
            prev_end, prev_ts = end, ts
    return out


def generator_off_share(a_dir, b_blobs) -> tuple[float, int]:
    """The largest share of bytes differing by more than one between the
    blobs of `b_blobs` ({relative path: uint8 array}, or a directory whose
    .npy files are compared) and the same files under a_dir."""
    if not isinstance(b_blobs, dict):
        b_blobs = {str(p.relative_to(b_blobs)): np.fromfile(p, np.uint8)
                   for p in sorted(Path(b_blobs).rglob("*.npy"))}
    worst = 0.0
    for rel, b in b_blobs.items():
        a = np.fromfile(Path(a_dir) / rel, np.uint8).astype(np.int16)
        b = np.asarray(b, np.uint8).reshape(-1).astype(np.int16)
        if a.shape != b.shape:
            raise SystemExit(f"{rel}: {a.shape} against {b.shape}")
        worst = max(worst, float((np.abs(a - b) > 1).mean()))
    if not b_blobs:
        raise SystemExit(f"no blobs to compare with {a_dir}")
    return worst, len(b_blobs)


def blob_off_share(a_dir, b_dir, split):
    """The largest share of bytes differing by more than one between the
    TAF blobs of `split` under two trees, over every blob of a_dir."""
    worst, n = 0.0, 0
    for bins in ("bins4", "bins8"):
        for path in sorted((Path(a_dir) / split / bins).glob("*.npy")):
            a = np.fromfile(path, np.uint8).astype(np.int16)
            b = np.fromfile(Path(b_dir) / split / bins / path.name,
                            np.uint8).astype(np.int16)
            if a.shape != b.shape:
                raise SystemExit(f"{path.name}: {a.shape} against {b.shape}")
            worst = max(worst, float((np.abs(a - b) > 1).mean()))
            n += 1
    if not n:
        raise SystemExit(f"no blobs under {a_dir}/{split}")
    return worst, n


def run_data_path(counters, dev, card, synthetic_train):
    """Phase 28: the data path at full GEN1 width. A synthetic GEN1 tree
    (build_gen1_tree); tools.generate_taf on the card (every split) and on
    the CPU (val), the val blobs held card against CPU and each against
    the oracle's (BLOB_GATE); Trainer.train() of taf_bfm / gen1 (the AED
    256 wide, bfm stem, batch 64, bf16 over f32 masters) for TREE_EPOCHS
    epochs with validation every epoch, every loss and COCO stat finite,
    last_epoch and best_epoch written, no kernel launched; one more epoch
    under torch.profiler for the device's busy share; then cli.test in a
    subprocess on the val split as its test split, whose stats must equal
    the in-process validation of best_epoch to 1e-6. Prints ms/step and
    the share of it the loop waited for the loader, the evaluator's
    seconds and the generator's ms a blob beside phase 17's synthetic
    gen1_train. Returns what phase 29 needs."""
    from frlw_evd_tpu_torch import train
    from frlw_evd_tpu_torch.tools.generate_taf import generate_taf
    from frlw_evd_tpu_torch.utils.profiling import device_busy_us

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    tree = build_gen1_tree(str(WORK / "gen1"))
    log(f"GEN1 tree ({TRAIN_STREAMS} + {VAL_STREAMS} streams of "
        f"{GEN1_TREE['duration'] / 1e6:.1f} s, "
        f"{len(GEN1_TREE['ann_times'])} annotation times each; the val "
        f"split's oracle TAF blobs): {time.perf_counter() - t0:.1f} s")
    out = {d: str(WORK / f"gen_{d}") for d in ("cuda", "cpu")}
    gen = {"cuda": generate_taf(tree["events"], tree["labels"], out["cuda"],
                                "gen1", dev),
           "cpu": generate_taf(tree["events"], tree["labels"], out["cpu"],
                               "gen1", "cpu", splits=("val",))}
    n_train = len(list((Path(out["cuda"]) / "taf" / "train" / "bins8")
                       .glob("*.npy")))
    if n_train != TRAIN_STREAMS * len(GEN1_TREE["ann_times"]):
        raise SystemExit(f"generate_taf wrote {n_train} train blobs")
    pairs = {"card vs CPU": (out["cuda"] + "/taf", out["cpu"] + "/taf"),
             "card vs oracle": (out["cuda"] + "/taf", tree["taf_dir"]),
             "CPU vs oracle": (out["cpu"] + "/taf", tree["taf_dir"])}
    for label, (a, b) in pairs.items():
        worst, n = blob_off_share(a, b, "val")
        log(f"generate_taf val blobs, {label}: largest share off by more "
            f"than one {worst:.2e} over {n} blobs (gate {BLOB_GATE})")
        if worst >= BLOB_GATE:
            raise SystemExit(f"generate_taf {label}: {worst} >= {BLOB_GATE}")
    gen_ms = {d: g["encode_s"] / g["blobs"] * 1e3 for d, g in gen.items()}
    log(f"generate_taf on {card}: {gen_ms['cuda']:.2f} ms a blob pair over "
        f"{gen['cuda']['blobs']}; the CPU {gen_ms['cpu']:.2f} over "
        f"{gen['cpu']['blobs']} (queue update to host read, host clock)")

    name = "gen1_taf_bfm"
    cfg = train.make_config(
        "taf_bfm", dataset="gen1", batch_size=TREE_BATCH,
        data_path=out["cuda"] + "/taf", bbox_path=tree["labels"],
        log_path=str(WORK / "log"), exp_name=name, event_volume_bins=K,
        max_epoch_to_stop=TREE_EPOCHS, reduce_evaluate=False)
    for fn in counters.values():
        fn.launches = 0
    trainer = train.Trainer(cfg, device=dev)
    trainer.train()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise SystemExit(f"the Trainer launched a kernel: {launches}")
    hist = trainer.history
    if len(hist) != TREE_EPOCHS or any("val" not in h for h in hist):
        raise SystemExit(f"Trainer.train ran {len(hist)} epochs")
    losses = [v for h in hist for lo in h["losses"] for v in lo.values()]
    stats = [v for h in hist for v in h["val"]["stats"]]
    if not (all(np.isfinite(losses)) and all(np.isfinite(stats))):
        raise SystemExit(f"non-finite loss or COCO stat: {hist}")
    ckpts = Path(trainer.ckpt_dir)
    for f in ("last_epoch", "best_epoch", "last_epoch_backbone.pth",
              "last_epoch_neck.pth"):
        if not (ckpts / f).exists():
            raise SystemExit(f"Trainer.train wrote no {f}")
    for h in hist:
        log(f"epoch {h['epoch']} on {card}: {h['steps']} steps at batch "
            f"{TREE_BATCH}, {h['wall_s'] / h['steps'] * 1e3:.1f} ms/step, "
            f"the loop waiting for the loader "
            f"{h['loader_wait_s'] / h['wall_s']:.1%} of it; total_loss by "
            f"step " + ", ".join(f"{lo['total_loss']:.4f}"
                                 for lo in h["losses"])
            + f"; validation {h['val']['loop_s']:.2f} s detecting, "
            f"{h['val']['coco_s']:.3f} s in the evaluator, COCO stats "
            + ", ".join(f"{v:.4f}" for v in h["val"]["stats"]))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer.train_epoch()
    prof_epoch = trainer.history[-1]
    busy = device_busy_us(prof.events()) / 1e6
    log(f"one more epoch under torch.profiler: "
        f"{prof_epoch['wall_s'] / prof_epoch['steps'] * 1e3:.1f} ms/step, "
        f"the device busy {busy / prof_epoch['wall_s']:.1%} of it, the loop "
        f"waiting for the loader "
        f"{prof_epoch['loader_wait_s'] / prof_epoch['wall_s']:.1%}; phase 17's "
        f"synthetic gen1_train (device-resident batches) "
        f"{synthetic_train['ms_per_step']:.1f} ms/step")

    best = next(h for h in hist if h["val"]["stats"][0] == trainer.max_score)
    for split_dir in (Path(tree["labels"]), Path(out["cuda"]) / "taf"):
        shutil.rmtree(split_dir / "test", ignore_errors=True)
        (split_dir / "test").symlink_to("val")
    cmd = [sys.executable, "-m", "frlw_evd_tpu_torch.cli.test",
           "--exp_type", "taf_bfm", "--dataset", "gen1",
           "--batch_size", str(TREE_BATCH), "--event_volume_bins", str(K),
           "--data_path", cfg.data_path, "--bbox_path", cfg.bbox_path,
           "--log_path", cfg.log_path, "--resume_exp", name]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"cli.test failed:\n{res.stdout}\n{res.stderr}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("COCO stats:")][-1]
    cli_stats = np.array(ast.literal_eval(line.split(":", 1)[1]),
                         np.float64)
    diff = np.abs(cli_stats - np.array(best["val"]["stats"])).max()
    log(f"cli.test --resume_exp {name} (best_epoch = epoch {best['epoch']}) "
        f"in {time.perf_counter() - t0:.1f} s: {line}; within {diff:.1e} "
        f"of the in-process validation")
    if diff > 1e-6:
        raise SystemExit(f"cli.test stats {cli_stats} against the "
                         f"in-process {best['val']['stats']}")
    return dict(tree=tree, checkpoint=str(ckpts / "best_epoch"),
                taf_dir=out["cuda"] + "/taf")


def b6_at_batch_one(enc, windows, sensor, rate):
    """B6 on the cells of stream_infer's windows (B = 1, E = MAX_EVENTS,
    t as scatter_cnt_tsum_mxu rounds it), bit for bit with its twin on
    every window; timed on the busiest window beside its twin, index_add_
    and its bound. Returns the timings."""
    H, W = sensor
    size = H * W * 2
    busiest = None
    for xytp, nv in windows:
        idx, tv, valid = enc.event_cells(xytp, nv, H, W)
        hi = tv.to(torch.bfloat16).float()
        t = hi + (tv - hi).to(torch.bfloat16).float()
        cnt, tsum = enc.scatter_cnt_tsum_pallas_sorted(idx, t, valid, size)
        p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_sorted_plain(idx, t, valid,
                                                                 size)
        if not (torch.equal(cnt, p_cnt) and torch.equal(tsum, p_tsum)):
            raise SystemExit("B6 at B = 1: counts or t-sums differ from the "
                             "twin's")
        if busiest is None or int(nv[0]) > int(busiest[-1][0]):
            busiest = (idx, t, valid, nv)
    idx, t, valid, nv = busiest
    ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(idx, t, valid,
                                                            size))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted_plain(
        idx, t, valid, size), n=5)
    library_ms = index_add_ms(idx, t, valid, size)
    bound_ms = (idx.numel() * (4 + 4 + 1) + 2 * size * 4) / rate * 1e3
    log(f"B6 at B = 1, E = {idx.shape[1]}: bit for bit with its twin on all "
        f"{len(windows)} windows; on the busiest ({int(nv[0])} events) "
        f"{ms:.4f} ms, twin {plain_ms:.3f}, index_add_ {library_ms:.4f}, "
        f"bound {bound_ms:.4f} ms (bytes)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes", events=int(nv[0]))


def run_stream_infer(enc, pipeline, data, counters, dev, card, rate):
    """Phase 29: tools.stream_infer over one 2 s recording of phase 28's
    tree at full GEN1 width, batch 1, f32: first B6 against its twin on
    every window (b6_at_batch_one); then 5 windows through the tool's
    command line with phase 28's best_epoch (-checkpoint), then
    STREAM_WINDOWS windows with the AED's weights spread as in phase 4:
    B6 launched once every window, every detection finite, the -out npz
    in the JAX tool's layout.
    Prints windows/s and each window's latency p50 / p99 (host clock, to
    the tool's host read). Returns the launch counts and B6's timings."""
    from frlw_evd_tpu_torch.events import PSEELoader
    from frlw_evd_tpu_torch.models import build_detector
    from frlw_evd_tpu_torch.tools import stream_infer as si

    event_file = str(Path(data["tree"]["events"]) / "train" / "train0_td.dat")
    sensor, _, nc = si.geometry("gen1")
    loader = PSEELoader(event_file)
    windows = []
    while not loader.done and len(windows) < STREAM_WINDOWS:
        events = loader.load_delta_t(si.BIN_US)
        xytp, n = si.window_events(events, int(loader.current_time), "gen1")
        windows.append((torch.from_numpy(xytp)[None].to(dev),
                        torch.tensor([n], dtype=torch.int32, device=dev)))
    if len(windows) < STREAM_WINDOWS:
        raise SystemExit(f"the recording holds {len(windows)} windows")
    b6 = b6_at_batch_one(enc, windows, sensor, rate)
    del windows

    # phase 28's best_epoch through the tool's own entry, 5 windows (the
    # warm-up); then the timed run with phase 4's spread random weights, so
    # that boxes pass conf 0.3 as with trained weights
    si.main(["-event_file", event_file, "-dataset", "gen1", "-checkpoint",
             data["checkpoint"], "-max_windows", "5"])
    model = gen1_model(build_detector, pipeline).to(dev).eval()
    model.to(memory_format=torch.channels_last)
    npz = WORK / "stream_infer.npz"
    for fn in counters.values():
        fn.launches = 0
    res = si.stream_infer(event_file, "gen1", out=str(npz),
                          max_windows=STREAM_WINDOWS, device=dev,
                          model=model, verbose=False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    n = len(res["ts"])
    if n != STREAM_WINDOWS or launches[B6] != n or any(
            v for k, v in launches.items() if k != B6):
        raise SystemExit(f"stream_infer: {n} windows, launches {launches}")
    if not all(np.isfinite(d).all() for d in res["dets"]):
        raise SystemExit("stream_infer: a non-finite detection")
    saved = np.load(npz)
    rows = sum(len(d) for d in res["dets"])
    want_t = np.concatenate([np.full(len(d), t) for d, t in
                             zip(res["dets"], res["ts"])])
    if (saved["dts"].shape != (rows, 7) or len(saved["file_names"]) != rows
            or not np.array_equal(saved["dts"][:, 0], want_t)):
        raise SystemExit(f"stream_infer npz: dts {saved['dts'].shape}, "
                         f"{len(saved['file_names'])} names, {rows} rows")
    lat = np.array(res["window_s"]) * 1e3
    kept = sum(int((d[:, 5] > 0).sum()) for d in res["dets"])
    log(f"stream_infer on {card}: {n} windows in {res['elapsed_s']:.2f} s = "
        f"{n / res['elapsed_s']:.1f} windows/s at batch 1; window latency "
        f"p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms, max {lat.max():.2f} ms (host "
        f"clock, file read to the host read of the detections); {kept} "
        f"detections; B6 launched {launches[B6]} times")
    return launches, b6


def small_stream_model(build_detector, pipeline):
    """A narrow AED (stem bfm, 32 wide, 2 classes) with phase 5's spread
    random weights, in training mode, dropout off."""
    model = build_detector(2, stem="bfm", in_channels=(32, 32, 32),
                           stem_out_channels=16, head_width=32,
                           dropout_rate=0.0, train=True,
                           generator=torch.Generator().manual_seed(0))
    return pipeline.spread_random_weights_(model,
                                           torch.Generator().manual_seed(1))


def same_dets(label, got, want):
    """Per window the same number of rows, each CPU row matched to a
    distinct card row with the box and the score within DET_GATES (rows
    whose scores tie may come in another order); prints the rows of one
    side only otherwise. Returns the largest box and score errors."""
    worst = {"box": 0.0, "score": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        free = list(range(len(g)))
        unmatched = []
        for row in w:
            limit = (DET_GATES["box_atol"]
                     + DET_GATES["box_rtol"] * np.abs(row[:-1]))
            err = [(np.abs(g[j, :-1] - row[:-1]).max(),
                    abs(g[j, -1] - row[-1]), j) for j in free
                   if (np.abs(g[j, :-1] - row[:-1]) <= limit).all()]
            hits = [e for e in err if e[1] <= DET_GATES["score"]]
            if not hits:
                unmatched.append(row)
                continue
            box, score, j = min(hits)
            free.remove(j)
            worst = {"box": max(worst["box"], float(box)),
                     "score": max(worst["score"], float(score))}
        if unmatched or free:
            raise SystemExit(
                f"{label} window {i}: {len(g)} rows on the card, {len(w)} on "
                f"the CPU; CPU rows without a card row within {DET_GATES}: "
                f"{unmatched}; card rows left: {[g[j] for j in free]}")
    return worst


def check_data_path_against_cpu(pipeline, build_detector, dev):
    """Phase 30: card against CPU, small, f32 with TF32 off. One epoch of
    a taf_bfm Trainer with small_stream_model on a 120x152 → 128x160
    synthetic tree (3 steps at batch 2): losses within phase 19's rtol
    2e-4, BatchNorm statistics within 1e-5; then eval_epoch: each window's
    detections by DET_GATES, the COCO stats within STATS_GATE. Then the
    first 20 windows of tools.stream_infer on a 60x76 recording
    (gen1_mini) with that model in eval mode: DET_GATES."""
    from frlw_evd_tpu_torch import train
    from frlw_evd_tpu_torch.data import synthetic
    from frlw_evd_tpu_torch.tools import stream_infer as si

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tree = synthetic.build_mini_gen1(
            str(WORK / "small"), np.random.default_rng(3),
            sensor_hw=(120, 152), input_hw=(128, 160), blobs=("taf",))
        runs = {}
        for d in ("cpu", dev):
            cfg = train.make_config(
                "taf_bfm", dataset="gen1", batch_size=2, num_workers=1,
                data_path=tree["taf_dir"], bbox_path=tree["labels"],
                log_path=str(WORK / "small_log"), exp_name=f"small_{d}",
                event_volume_bins=K, augmentation=False,
                half_precision=False, img_size_override=(128, 160),
                sensor_hw_override=(120, 152))
            trainer = train.Trainer(cfg, device=d)
            trainer.model = small_stream_model(build_detector, pipeline)
            trainer.create_datasets()
            trainer.build(len(trainer.train_loader))
            trainer.train_epoch()
            evaluator = trainer.make_evaluator()
            coco = trainer.eval_epoch(evaluator)
            sd = {k: v.cpu() for k, v in trainer.model.state_dict().items()
                  if k.endswith(STATS)}
            runs[d] = (trainer.history[-1]["losses"], sd,
                       evaluator.dt_to_eval, np.array(coco))
        (c_loss, c_sd, c_dt, c_coco), (g_loss, g_sd, g_dt, g_coco) = (
            runs["cpu"], runs[dev])
        loss_err = max(abs(g[k] / c[k] - 1) for g, c in zip(g_loss, c_loss)
                       for k in c if c[k] != 0)
        stat_err = max((g_sd[k] - v).abs().max().item()
                       for k, v in c_sd.items())
        if loss_err > SMALL_TRAIN_GATES["losses"] or (
                stat_err > SMALL_TRAIN_GATES["statistics"]):
            raise SystemExit(f"small Trainer epoch: losses rel err "
                             f"{loss_err}, statistics err {stat_err}")
        det_err = same_dets("small eval_epoch", g_dt, c_dt)
        coco_err = np.abs(g_coco - c_coco).max()
        log(f"small Trainer epoch, card vs CPU: {len(c_loss)} steps, losses "
            f"rel err {loss_err:.2e}, BatchNorm statistics err "
            f"{stat_err:.2e}; eval_epoch over {len(c_dt)} windows: "
            f"detections within {det_err}, COCO stats "
            + ", ".join(f"{v:.4f}" for v in c_coco)
            + f" within {coco_err:.1e}")
        if coco_err > STATS_GATE:
            raise SystemExit(f"small eval_epoch: COCO stats {g_coco} on the "
                             f"card, {c_coco} on the CPU")

        mini = synthetic.build_mini_gen1(
            str(WORK / "mini"), np.random.default_rng(4), streams=("seq0",),
            splits=("test",), blobs=())
        event_file = str(Path(mini["events"]) / "test" / "seq0_td.dat")
        model = small_stream_model(build_detector, pipeline).eval()
        dets = {}
        for d in ("cpu", dev):
            model.to(d)
            dets[d] = si.stream_infer(event_file, "gen1_mini",
                                      max_windows=20, device=d, model=model,
                                      verbose=False)["dets"]
        err = same_dets("small stream_infer", dets[dev], dets["cpu"])
        log(f"small stream_infer (60x76 → 64x96), card vs CPU: 20 windows, "
            f"{sum(len(x) for x in dets['cpu'])} rows, within {err}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _val0_tree(tree) -> tuple[str, str]:
    """(events, labels) directories holding only the val split's first
    stream, as links into `tree`: the CPU generators' input."""
    root = WORK / "val0"
    for key, name in (("events", "val0_td.dat"), ("labels", "val0_bbox.npy")):
        (root / key / "val").mkdir(parents=True, exist_ok=True)
        (root / key / "val" / name).symlink_to(
            Path(tree[key]) / "val" / name)
    return str(root / "events"), str(root / "labels")


def run_generators(data, counters, dev, card):
    """Phase 31: tools.generate_eventvolume, generate_eventcountimage and
    generate_surfaceofactiveevents at full GEN1 geometry (240x304 →
    256x320) over phase 28's tree: on the card every split, on the CPU the
    first val stream. That stream's blobs card against CPU, and each
    against oracle_generator_blobs (encode/oracle.py, computed in spawned
    processes meanwhile), at BLOB_GATE; no kernel launched. Prints the ms
    an encode takes (host copy, encode, read-back; host clock) on each
    device. Returns the card's EV (250 ms) blob directory for phase 32."""
    from frlw_evd_tpu_torch.tools import (generate_eventcountimage,
                                          generate_eventvolume,
                                          generate_surfaceofactiveevents)

    tree = data["tree"]
    mods = {"eventvolume": generate_eventvolume,
            "eventcountimage": generate_eventcountimage,
            "surfaceofactiveevents": generate_surfaceofactiveevents}
    val0 = _val0_tree(tree)
    n_times = len(GEN1_TREE["ann_times"])
    # the numpy oracle (about 20 s for the EV blobs of one GEN1 stream)
    # runs in processes of its own while the generators run here
    with ProcessPoolExecutor(len(GENERATORS),
                             mp_context=get_context("spawn")) as pool:
        t0 = time.perf_counter()
        oracles = {tool: pool.submit(
            oracle_generator_blobs, tool,
            str(Path(tree["events"]) / "val" / "val0_td.dat"),
            str(Path(tree["labels"]) / "val" / "val0_bbox.npy"),
            GEN1_SENSOR, GEN1_INPUT) for tool in GENERATORS}
        _run_generators(mods, tree, val0, n_times, oracles, counters, dev,
                        card)
        log(f"the oracle's val0 blobs of the three tools: "
            f"{time.perf_counter() - t0:.1f} s from their start, in "
            f"{len(GENERATORS)} processes")
    return str(WORK / "eventvolume_cuda" / "EventVolume250000")


def _run_generators(mods, tree, val0, n_times, oracles, counters, dev,
                    card):
    for fn in counters.values():
        fn.launches = 0
    for tool in GENERATORS:
        gen = getattr(mods[tool], f"generate_{tool}")
        dirs = {d: str(WORK / f"{tool}_{d}") for d in ("cuda", "cpu")}
        t0 = time.perf_counter()
        stats = {"cuda": gen(tree["events"], tree["labels"], dirs["cuda"],
                             "gen1", dev)}
        t1 = time.perf_counter()
        stats["cpu"] = gen(*val0, dirs["cpu"], "gen1", "cpu")
        t2 = time.perf_counter()
        encodes = 1 if tool == "surfaceofactiveevents" else 3
        want = (TRAIN_STREAMS + VAL_STREAMS) * n_times * encodes
        if (stats["cuda"]["blobs"], stats["cpu"]["blobs"]) != (
                want, n_times * encodes):
            raise SystemExit(f"generate_{tool} encoded {stats}")
        oracle = oracles[tool].result()
        for label, (a, b) in {"card vs CPU": (dirs["cuda"], dirs["cpu"]),
                              "card vs oracle": (dirs["cuda"], oracle),
                              "CPU vs oracle": (dirs["cpu"], oracle)}.items():
            worst, n = generator_off_share(a, b)
            log(f"generate_{tool} val0 blobs, {label}: largest share off by "
                f"more than one {worst:.2e} over {n} blobs (gate "
                f"{BLOB_GATE})")
            if worst >= BLOB_GATE or n != 3 * n_times:
                raise SystemExit(f"generate_{tool} {label}: {worst} over "
                                 f"{n} blobs")
        ms = {d: st["encode_s"] / st["blobs"] * 1e3
              for d, st in stats.items()}
        log(f"generate_{tool} on {card}: {ms['cuda']:.2f} ms an encode over "
            f"{stats['cuda']['blobs']} ({t1 - t0:.1f} s in all); the CPU "
            f"{ms['cpu']:.2f} over {stats['cpu']['blobs']} ({t2 - t1:.1f} "
            f"s) (host copy up, encode, host read; host clock)")
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise SystemExit(f"the generators launched a kernel: {launches}")


def run_trainer_families(train, data, ev_dir, counters, dev, card,
                         card_name, synthetic_train):
    """Phase 32: train_family (below) of `basic` (aed, focus stem, 10
    channels) on phase 31's EV blobs and of `yolox_taf_bfm` (CSPDarknet,
    bfm stem) on phase 28's TAF blobs, batch 64, full GEN1 width, beside
    phase 17's gen1_train."""
    for exp_type, data_path, bins in (("basic", ev_dir, 5),
                                      ("yolox_taf_bfm", data["taf_dir"], K)):
        train_family(train, exp_type, data_path, data["tree"]["labels"],
                     bins, counters, dev, card, card_name)
    log(f"phase 17's gen1_train (device-resident batches) "
        f"{synthetic_train['ms_per_step']:.1f} ms/step")


FOUR_WAYS = {"plain": {}, "remat": dict(remat=True), "p64": dict(p64=True),
             "remat_p64": dict(remat=True, p64=True)}
# four_ways_agree's pairs: (way, its counterpart, the stem's dropout)
AGREE_PAIRS = (("remat", "plain", 0.1), ("remat_dots", "plain", 0.1),
               ("remat_p64", "p64", 0.1), ("p64", "plain", 0.0))


def four_ways_agree(train, build_detector, dev):
    """Phase 33's check: one f32 step (TF32 off) of gen1_train at batch 64
    from the same weights, batch and dropout seed, each way against its
    counterpart (AGREE_PAIRS): remat, full and with the "dots" policy,
    against plain and remat_p64 against p64 with the stem's dropout at 0.1
    (the recompute must replay its masks), p64 against plain with dropout
    0 (the patched stem draws its masks in another layout). Losses within
    rtol 2e-4, BatchNorm running statistics within 1e-5
    (SMALL_TRAIN_GATES)."""
    cfg = train.TRAIN_CONFIGS["gen1_train"]
    vol, labels = train.synthetic_batches(np.random.default_rng(0), 1,
                                          cfg["batch"], cfg["input_hw"],
                                          cfg["num_classes"])[0]
    vol, labels = torch.from_numpy(vol).to(dev), torch.from_numpy(labels)
    base = build_detector(cfg["num_classes"], stem="bfm", train=True,
                          generator=torch.Generator().manual_seed(0))

    ways = {**FOUR_WAYS, "remat_dots": dict(remat=True,
                                            remat_policy="dots")}

    def one_step(way, dropout):
        kw = ways[way]
        p64 = kw.get("p64", False)
        model = build_detector(cfg["num_classes"],
                               stem="bfm_p64" if p64 else "bfm", train=True,
                               dropout_rate=dropout)
        model.load_state_dict(base.state_dict())
        state = train.create_train_state(model, train.adam(1e-3),
                                         device=dev)
        step = train.make_train_step(
            (8, 16, 32), cfg["num_classes"], 2.5, device=dev, patchify=p64,
            remat=kw.get("remat", False),
            remat_policy=kw.get("remat_policy"))
        losses = step(state, vol, labels,
                      torch.Generator(device=dev).manual_seed(1))
        out = ({k: float(v) for k, v in losses.items()},
               {k: v.cpu() for k, v in model.state_dict().items()
                if k.endswith(STATS)})
        del state, model
        torch.cuda.empty_cache()
        return out

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        refs = {}
        for way, ref, dropout in AGREE_PAIRS:
            if (ref, dropout) not in refs:
                refs[ref, dropout] = one_step(ref, dropout)
            (got, got_sd), (want, want_sd) = (one_step(way, dropout),
                                              refs[ref, dropout])
            loss_err = max(abs(got[k] / want[k] - 1) for k in want
                           if want[k] != 0)
            stat_err = max((got_sd[k] - v).abs().max().item()
                           for k, v in want_sd.items())
            log(f"gen1_train f32 first step, {way} against {ref} (dropout "
                f"{dropout}): losses rel err {loss_err:.2e}, BatchNorm "
                f"statistics err {stat_err:.2e}; total_loss "
                f"{got['total_loss']:.6f} / {want['total_loss']:.6f}")
            if (loss_err > SMALL_TRAIN_GATES["losses"]
                    or stat_err > SMALL_TRAIN_GATES["statistics"]):
                raise SystemExit(f"{way} against {ref}: losses {got} / "
                                 f"{want}, statistics err {stat_err}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def run_train_four_ways(train, build_detector, counters, dev, card,
                        card_name):
    """Phase 33: gen1_train at batch 64, full width, on device-resident
    batches, four ways: plain, remat (full), p64 (patchify) and both.
    First four_ways_agree; then each way through train.run_train (bf16
    over f32 masters, dropout on): TRAIN_WARMUP + TRAIN_STEPS steps, every
    loss finite, no kernel launched; ms/step, peak memory and MFU, the
    FLOPs of each way's model (the plain way's for remat, p64's for
    remat_p64: recomputed FLOPs are not the model's)."""
    four_ways_agree(train, build_detector, dev)
    reps = {}
    for way, kw in FOUR_WAYS.items():
        for fn in counters.values():
            fn.launches = 0
        rep = train.run_train("gen1_train", steps=TRAIN_STEPS,
                              warmup=TRAIN_WARMUP, device=dev, **kw)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        if any(launches.values()):
            raise SystemExit(f"gen1_train {way} launched a kernel: "
                             f"{launches}")
        if not all(np.isfinite(v) for lo in rep["losses"]
                   for v in lo.values()):
            raise SystemExit(f"gen1_train {way}: a non-finite loss")
        plain_way = {"remat": "plain", "remat_p64": "p64"}.get(way)
        model_flops = (reps[plain_way]["flops_per_step"] if plain_way
                       else rep["flops_per_step"])
        mfu = model_flops / (rep["ms_per_step"] / 1e3) / bf16_tensor_flops(
            card_name)
        reps[way] = dict(ms_per_step=rep["ms_per_step"],
                         peak_gib=rep["peak_bytes"] / 2**30, mfu=mfu,
                         flops_per_step=rep["flops_per_step"])
        log(f"gen1_train {way} on {card}: {rep['ms_per_step']:.2f} ms/step "
            f"at batch {rep['batch']}, peak memory "
            f"{rep['peak_bytes'] / 2**30:.2f} GiB, "
            f"{rep['flops_per_step'] / 1e12:.3f} TFLOP/step counted, MFU "
            f"{mfu:.2%} (the model's {model_flops / 1e12:.3f} TFLOP/step)")
        del rep
        torch.cuda.empty_cache()
    for way in ("remat", "p64", "remat_p64"):
        log(f"gen1_train {way} against plain: ms/step x"
            f"{reps[way]['ms_per_step'] / reps['plain']['ms_per_step']:.3f}"
            f", peak memory x"
            f"{reps[way]['peak_gib'] / reps['plain']['peak_gib']:.3f}")
    return reps


def yolox_gen1_model(build_detector, pipeline):
    """Phase 34's yolox_taf_bfm model (CSPDarknet, bfm stem, 2 classes)
    with seeded random weights spread as phase 4's, f32 on the CPU."""
    model = build_detector(2, family="yolox", stem="bfm",
                           generator=torch.Generator().manual_seed(0))
    return pipeline.spread_random_weights_(model,
                                           torch.Generator().manual_seed(1))


def run_yolox_path(pipeline, build_detector, counters, windows, dev, card):
    """Phase 34: the yolox_taf_bfm model served through
    make_pipeline_kernel at GEN1, B = 128, E = 16384, bf16, as phase 4
    (B1 and B2 on every window), then phase 5's card-against-CPU check
    with a small yolox model. Returns the launch counts of its run."""
    launches = run_main_path(pipeline, counters, windows, dev, card,
                             model=yolox_gen1_model(build_detector, pipeline),
                             label="yolox path")
    check_small_against_cpu(pipeline, dev, family="yolox")
    return launches


# phase 35's blob geometry: GEN1's sensor resized up to the yolov3
# config's square input (train/config.py: make_config)
YOLOV3_SIZE = (640, 640)
# phase 36's exp types on EV blobs of 5 bins
RECURRENT_RUNS = ("red", "convlstm", "recconv")


def train_family(train, exp_type, data_path, labels, bins, counters, dev,
                 card, card_name, batch=TREE_BATCH):
    """Trainer.train() of `exp_type` at `batch` for one epoch with
    validation, its config's geometry and widths, bf16 over f32 masters.
    Holds: at least 3 steps, every loss and COCO stat finite, best_epoch
    written, no kernel launched. Then counts the FLOPs of one more train
    step (utils/profiling.flops_report, as phase 17 counts them), and
    runs Trainer.test() of a fresh Trainer on best_epoch with the val
    split as its test split (phase 28's links): its stats within 1e-6 of
    the epoch's validation. Returns the run's numbers."""
    from frlw_evd_tpu_torch.models.yolov3 import gt_creator
    from frlw_evd_tpu_torch.utils.profiling import flops_report

    cfg = train.make_config(
        exp_type, dataset="gen1", batch_size=batch, data_path=data_path,
        bbox_path=labels, log_path=str(WORK / "log"),
        exp_name=f"gen1_{exp_type}", event_volume_bins=bins,
        max_epoch_to_stop=1, reduce_evaluate=False)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer = train.Trainer(cfg, device=dev)
    trainer.train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: fn.launches for k, fn in counters.items()}
    if any(launches.values()):
        raise SystemExit(f"{exp_type}: the Trainer launched a kernel: "
                         f"{launches}")
    hist = trainer.history
    if len(hist) != 1 or hist[0]["steps"] < 3 or "val" not in hist[0]:
        raise SystemExit(f"{exp_type}: Trainer.train ran {hist}")
    h = hist[0]
    losses = [v for lo in h["losses"] for v in lo.values()]
    if not (all(np.isfinite(losses)) and all(np.isfinite(h["val"]["stats"]))):
        raise SystemExit(f"{exp_type}: non-finite loss or COCO stat: {h}")
    if not (Path(trainer.ckpt_dir) / "best_epoch").exists():
        raise SystemExit(f"{exp_type}: Trainer.train wrote no best_epoch")
    imgs, targets = next(iter(trainer.train_loader))[:2]
    if cfg.family == "yolov3":
        targets = torch.from_numpy(gt_creator(cfg.img_size[0], cfg.strides,
                                              targets.numpy()))
    flops = flops_report(trainer.train_step, trainer.state, imgs, targets,
                         trainer.generator)["flops"]
    ms = h["wall_s"] / h["steps"] * 1e3
    mfu = flops / (ms / 1e3) / bf16_tensor_flops(card_name)
    gt_s = h.get("gt_creator_s")
    log(f"{exp_type} ({type(trainer.model).__name__}, "
        f"{cfg.img_size[0]}x{cfg.img_size[1]}, {cfg.input_channels} "
        f"channels) on {card}: {h['steps']} steps at batch {batch}, "
        f"{ms:.1f} ms/step, the loop waiting for the loader "
        f"{h['loader_wait_s'] / h['wall_s']:.1%} of it"
        + (f" (gt_creator {gt_s / h['steps'] * 1e3:.1f} ms a step of that)"
           if gt_s is not None else "")
        + f", peak memory {peak / 2**30:.2f} GiB, {flops / 1e12:.3f} "
        f"TFLOP/step counted, MFU {mfu:.2%}; total_loss by step "
        + ", ".join(f"{lo['total_loss']:.4f}" for lo in h["losses"])
        + f"; validation {h['val']['loop_s']:.2f} s detecting, COCO stats "
        + ", ".join(f"{v:.4f}" for v in h["val"]["stats"]))
    out = dict(batch=batch, steps=h["steps"], ms_per_step=ms,
               loader_wait=h["loader_wait_s"] / h["wall_s"],
               peak_gib=peak / 2**30, tflop_per_step=flops / 1e12, mfu=mfu)
    del trainer
    torch.cuda.empty_cache()
    for root in (Path(data_path), Path(labels)):
        if not (root / "test").is_symlink():
            shutil.rmtree(root / "test", ignore_errors=True)
            (root / "test").symlink_to("val")
    t0 = time.perf_counter()
    tested = np.array(train.Trainer(
        dataclasses.replace(cfg, resume_exp=cfg.exp_name), device=dev).test())
    diff = np.abs(tested - np.array(h["val"]["stats"])).max()
    log(f"{exp_type}: Trainer.test() on best_epoch in "
        f"{time.perf_counter() - t0:.1f} s, COCO stats within {diff:.1e} of "
        f"the epoch's validation")
    if not diff <= 1e-6:
        raise SystemExit(f"{exp_type}: Trainer.test() stats {tested} against "
                         f"the validation's {h['val']['stats']}")
    torch.cuda.empty_cache()
    return out


def run_yolov3_trainer(train, data, counters, dev, card, card_name):
    """Phase 35: TAF blobs of phase 28's tree (train and val) generated on
    the card at YOLOV3_SIZE, then train_family of yolov3_taf_bfm at
    TREE_BATCH; where a batch does not fit in the card's memory, at half
    of it, until one does (each try printed)."""
    from frlw_evd_tpu_torch.tools import generate_common
    from frlw_evd_tpu_torch.tools.generate_taf import generate_taf

    generate_common.GEOMETRY["gen1_640"] = dict(shape=GEN1_SENSOR,
                                                target_shape=YOLOV3_SIZE)
    t0 = time.perf_counter()
    gen = generate_taf(data["tree"]["events"], data["tree"]["labels"],
                       str(WORK / "gen_640"), "gen1_640", dev,
                       splits=("train", "val"))
    log(f"generate_taf at {YOLOV3_SIZE[0]}x{YOLOV3_SIZE[1]} on {card}: "
        f"{gen['blobs']} blob pairs in {time.perf_counter() - t0:.1f} s")
    return train_family_that_fits(train, "yolov3_taf_bfm",
                                  str(WORK / "gen_640" / "taf"),
                                  data["tree"]["labels"], K, counters, dev,
                                  card, card_name)


def train_family_that_fits(*args):
    """train_family(*args) at TREE_BATCH; where a batch does not fit in
    the card's memory, at half of it, until one does (each try printed)."""
    batch = TREE_BATCH
    while True:
        try:
            return train_family(*args, batch=batch)
        except torch.cuda.OutOfMemoryError:
            if batch <= 8:
                raise
        # outside the handler, so that the failed run's frames are gone
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{args[1]} at batch {batch}: out of the card's memory; trying "
            f"{batch // 2}")
        batch //= 2


def run_recurrent_trainers(train, data, ev_dir, counters, dev, card,
                           card_name):
    """Phase 36: train_family of red, convlstm and recconv on phase 31's EV
    blobs at GEN1, batch TREE_BATCH."""
    return {exp_type: train_family(train, exp_type, ev_dir,
                                   data["tree"]["labels"], 5, counters, dev,
                                   card, card_name)
            for exp_type in RECURRENT_RUNS}


FAMILY_SMALL = {"yolov3": (64, 64), "yolov3_taf_bfm": (64, 64),
                "red": (64, 96), "convlstm": (64, 96), "recconv": (64, 96),
                "taf_swin": (64, 96), "taf_corr": (64, 96),
                "taf_syn": (64, 96)}
# the exp types that phases 37 and 40 hold card against CPU
PR12_FAMILIES = ("yolov3", "yolov3_taf_bfm", "red", "convlstm", "recconv")
NEW_FAMILIES = ("taf_swin", "taf_corr", "taf_syn")
# Darknet-53's running variances reach 3 (l5_conv, 1024 channels on 2x2
# maps, 52 convolutions deep) and read 9.3e-6 apart on an H100 and the CPU
# in f32: the yolov3 families' statistics are held within 1e-5 of
# max(|CPU value|, 1), the others within 1e-5 absolute
STATS_RELATIVE = ("yolov3", "yolov3_taf_bfm")


def _detectable_(model):
    """Boxes from random weights that the eval steps keep, one per cell of
    the finest level and apart from each other, so that NMS suppresses
    none and no near tie of scores decides which box survives (each box's
    score differs between the card and the CPU by up to 6e-5 at full
    width): the YOLOv3 head's anchor 0 and the YOLOX head's objectness on
    level 0 only, objectness bias 3.0 (the others keep the focal prior,
    under conf 0.3), that level's box regressions scaled by 0.1 (YOLOX's
    size biases 1, so its squared decode gives boxes of about a stride);
    RED's
    first prior of level 0 only (every other prior's background bias +10,
    its scores under conf 0.01)."""
    with torch.no_grad():
        head = getattr(model, "head", None)
        if head is not None and hasattr(head, "head_det_1"):
            det = head.head_det_1
            reg = head.num_anchors * (det.out_channels // head.num_anchors
                                      - 4)
            det.bias[0] = 3.0
            det.weight[reg:reg + 4] *= 0.1
        elif head is not None:
            head.obj_preds_0.bias.fill_(3.0)
            head.reg_preds_0.weight.mul_(0.1)
            head.reg_preds_0.bias.copy_(torch.tensor([0.0, 0.0, 1.0, 1.0]))
        else:
            nc = model.predictor.num_classes
            for k in range(5):
                cls = getattr(model.predictor, f"cls_{k}")
                cls.bias[(1 if k == 0 else 0) * nc::nc] = 10.0


def family_small_step(train, exp_type, d, half=False):
    """One train step and one eval step of `exp_type`'s Trainer on device
    `d`: the Trainer's own model (seed 0, full width, dropout 0) and steps
    on small_train_batch at FAMILY_SMALL's size (yolov3: gt_creator's
    targets). First the eval step's rows before its threshold and NMS
    (eval_step.decoded: every anchor or prior of every level) on the
    seeded weights; then _detectable_, the train step and the eval step.
    build(1)'s warm-up lr is 0 at the first update, so the eval step sees
    the step's weights and statistics. Returns (losses, running
    statistics, decoded rows, detections per image) on the host."""
    from frlw_evd_tpu_torch.models.blocks import Dropout
    from frlw_evd_tpu_torch.models.postprocess import finalize_detections
    from frlw_evd_tpu_torch.models.yolov3 import gt_creator

    h, w = FAMILY_SMALL[exp_type]
    cfg = train.make_config(
        exp_type, dataset="gen1", batch_size=4, event_volume_bins=K,
        img_size_override=(h, w), half_precision=half,
        log_path=str(WORK / "family_small"), exp_name=exp_type)
    trainer = train.Trainer(cfg, device=d)
    for mod in trainer.model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    trainer.build(1)
    imgs, labels = small_train_batch(np.random.default_rng(0), h, w)
    if cfg.input_channels != imgs.shape[-1]:
        raise SystemExit(f"{exp_type}: {cfg.input_channels} input channels")
    targets = (gt_creator(h, cfg.strides, labels)
               if cfg.family == "yolov3" else labels)
    imgs = torch.from_numpy(imgs)
    rows = trainer.eval_step.decoded(trainer.state, imgs).double().cpu()
    _detectable_(trainer.model)
    losses = trainer.train_step(trainer.state, imgs,
                                torch.from_numpy(targets), trainer.generator)
    dets = finalize_detections(*trainer.eval_step(trainer.state, imgs))
    stats = {k: v.double().cpu()
             for k, v in trainer.model.state_dict().items()
             if k.endswith(STATS)}
    return {k: v.item() for k, v in losses.items()}, stats, rows, dets


def same_rows(label, got, want):
    """Decoded rows [cx, cy, w, h, conf, cls / conf...] of every anchor or
    prior, in order, card against CPU: the boxes within DET_GATES' box
    atol + rtol, the scores within its score gate. Returns the largest box
    and score errors."""
    box_err = (got[..., :4] - want[..., :4]).abs()
    score_err = (got[..., 4:] - want[..., 4:]).abs().max().item()
    limit = DET_GATES["box_atol"] + DET_GATES["box_rtol"] * want[..., :4].abs()
    if got.shape != want.shape or (box_err > limit).any() \
            or score_err > DET_GATES["score"]:
        raise SystemExit(
            f"{label}: card and CPU disagree before NMS: shapes "
            f"{tuple(got.shape)} / {tuple(want.shape)}, box err "
            f"{box_err.max().item()}, score err {score_err}; {DET_GATES}")
    return {"box": box_err.max().item(), "score": score_err}


def check_families_against_cpu(train, dev, exp_types=PR12_FAMILIES):
    """Phase 37 (and 40 with NEW_FAMILIES): family_small_step of each exp
    type on the card and the CPU in f32, TF32 off: the decoded rows of
    every level before NMS (same_rows) and the detections after it
    (same_dets) by DET_GATES, the losses within SMALL_TRAIN_GATES' rtol,
    the running statistics within its 1e-5 (of max(|CPU value|, 1) for
    STATS_RELATIVE). Then, in phase 37, red in bf16 on the card, its
    losses finite."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for exp_type in exp_types:
            (c_loss, c_sd, c_rows, c_dt), (g_loss, g_sd, g_rows, g_dt) = (
                family_small_step(train, exp_type, d) for d in ("cpu", dev))
            loss_err = max(abs(g_loss[k] / v - 1) for k, v in c_loss.items()
                           if v != 0)
            relative = exp_type in STATS_RELATIVE
            stat_err = max(((g_sd[k] - v).abs()
                            / (v.abs().clamp(min=1.0) if relative else 1.0)
                            ).max().item() for k, v in c_sd.items())
            row_err = same_rows(f"{exp_type} small eval step", g_rows,
                                c_rows)
            det_err = same_dets(f"{exp_type} small eval step", g_dt, c_dt)
            log(f"{exp_type} small step, card vs CPU: losses rel err "
                f"{loss_err:.2e} (total_loss {c_loss['total_loss']:.6f}), "
                f"BatchNorm statistics err {stat_err:.2e} "
                f"({'of max(|value|, 1)' if relative else 'absolute'}) over "
                f"{len(c_sd)} buffers, decoded rows before NMS "
                f"{tuple(c_rows.shape)} within {row_err}, eval step "
                f"{sum(len(x) for x in c_dt)} rows within {det_err}")
            if (loss_err > SMALL_TRAIN_GATES["losses"]
                    or stat_err > SMALL_TRAIN_GATES["statistics"]):
                raise SystemExit(f"{exp_type} small step: card and CPU "
                                 f"disagree: losses {g_loss} / {c_loss}, "
                                 f"statistics err {stat_err}")
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if "red" not in exp_types:
        return
    losses, _, _, _ = family_small_step(train, "red", dev, half=True)
    log(f"red small step in bf16 on the card: " + ", ".join(
        f"{k} {v:.6f}" for k, v in losses.items()))
    if not all(np.isfinite(list(losses.values()))):
        raise SystemExit(f"red bf16 small step: non-finite losses {losses}")


# phase 38's gate on the merged head's bf16 maps against the canonical
# head's, relative L2 a level: the sound merged head read 2.9e-4 on an
# H100 80GB HBM3 at 700 W (the merged BatchNorm runs in f32 on the conv's
# bf16 output, the canonical one in bf16), and a planted slice fault (two
# channels of one tower's layer-1 BatchNorm affine swapped,
# planted_fault_rel) read 2.9e-3 to 2.1e-2 in f32 on the CPU, the least
# at level 0's reg tower, the one that phase 38 plants and requires above
# the gate
MERGED_BF16_REL = 1e-3


def merged_gen1_models(build_detector, pipeline):
    """Phase 22's AED (int8_gen1_model) and a merged-head build carrying
    the same state_dict, both f32 on the CPU."""
    canon = int8_gen1_model(build_detector, pipeline)
    merged = build_detector(2, stem="bfm", head_merged=True)
    merged.load_state_dict(canon.state_dict())
    return canon, merged


def maps_rel_l2(a, b):
    """Relative L2 of each level's head maps a against b."""
    return [((x.double() - y.double()).norm() / y.double().norm()).item()
            for x, y in zip(a, b)]


def planted_fault_rel(merged, canon, vol):
    """maps_rel_l2 of the merged head against the canonical one with a
    slice fault planted in the merged model: channels 0 and 1 of level
    0's reg tower layer-1 BatchNorm affine swapped (restored after)."""
    bn = merged.head.reg_convs_0_1.bn
    with torch.no_grad():
        for t in (bn.weight, bn.bias):
            t[[0, 1]] = t[[1, 0]].clone()
        try:
            with torch.inference_mode():
                return maps_rel_l2(merged(vol), canon(vol))
        finally:
            for t in (bn.weight, bn.bias):
                t[[0, 1]] = t[[1, 0]].clone()


def merged_site_errors(quantize, model, vol, ctx):
    """Each merged tower conv of `model` on the unquantized forward's
    inputs: its int8 sites (ctx.merged) launched, the output held bit for
    bit to int8_conv2d_plain on the same codes and halves, and its
    relative L2 against the bf16 merged conv. Returns {(k, layer): rel}."""
    (head, sites), = ctx.merged.values()
    errs = {}

    def compare(k, layer, h):
        got = sites(k, layer, h)
        own = sites.sites[k, layer]
        parts = quantize.merged_parts(h, layer)[:len(own)]
        want = torch.cat([quantize.int8_conv2d_plain(x, s.wq, s.scale, s.inv)
                          for s, x in zip(own, parts)], dim=1)
        if not torch.equal(got, want):
            raise SystemExit(f"merged int8 site ({k}, {layer}): the kernel "
                             f"and int8_conv2d_plain differ")
        kernel = torch.cat([getattr(head, f"{b}_convs_{k}_{layer}").conv.weight
                            for b in ("cls", "reg")])
        ref = torch.nn.functional.conv2d(h, kernel.to(h.dtype), padding=1,
                                         groups=2 if layer else 1).double()
        errs[k, layer] = ((got.double() - ref).norm() / ref.norm()).item()
        return None                      # the bf16 forward goes on

    head.merged_hook = compare
    try:
        with torch.inference_mode():
            model(vol)
    finally:
        head.merged_hook = None
    return errs


def merged_tower_sites(quantize, W, rate, card_name):
    """int8_sites_on_card at the merged towers' site shapes at GEN1, B =
    128: layer 0's Cout-2W site and layer 1's two W → W halves a level;
    then the copy that makes each half a contiguous channels_last
    activation (a strided channel slice of the 2W-channel input), timed
    alone. Returns the sites' per-window row with the copies' ms."""
    g = torch.Generator(device="cuda").manual_seed(0)
    levels = [(GEN1_INPUT[0] // s, GEN1_INPUT[1] // s) for s in (8, 16, 32)]
    shapes = Counter({(3, 1, W, 2 * W, h, w): 1 for h, w in levels})
    shapes.update({(3, 1, W, W, h, w): 2 for h, w in levels})
    row = int8_sites_on_card(quantize, shapes, rate,
                             _rate(INT8_TENSOR_OPS_PER_S, card_name),
                             "GEN1 merged towers", g, False)
    copy_ms = 0.0
    for h, w in levels:
        x = torch.randn(B, 2 * W, h, w, device="cuda", generator=g).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for half in (x[:, :W], x[:, W:]):
            copy_ms += time_ms(lambda: half.contiguous(
                memory_format=torch.channels_last))
    half_bytes = sum(2 * B * W * h * w * 2 * 2 for h, w in levels)
    log(f"merged towers' layer-1 halves: copies {copy_ms:.3f} ms a window "
        f"({half_bytes / 1e6:.0f} MB read and written; bound "
        f"{half_bytes / rate * 1e3:.3f} ms)")
    return dict(row, copy_ms=copy_ms)


def run_merged_head_path(pipeline, quantize, build_detector, counters,
                         windows, dev, card, rate, card_name):
    """Phase 38: GEN1 serving with the merged head (bench.py --merged_head)
    through make_pipeline_kernel, B = 128, E = 16384, AED 256 wide, stem
    bfm, B1 + B2 on every window. bf16: MAIN_WINDOWS windows, the head
    maps of the last within MERGED_BF16_REL of the canonical build's on
    the same weights. int8: calibrated on the merged model (its scales
    keyed as the canonical model's sites), then INT8_WINDOWS windows:
    int8_conv2d launched (the canonical sites but the 12 tower convs, plus
    1 + 2 a level) x (windows) times; every canonical site within relative
    L2 0.04 of its bf16 conv and every merged site too (its launch held bit
    for bit to its twin), the head maps within 0.08 of bf16's; windows/s
    of the canonical and the merged build in turns, bf16 then int8 (the
    merged calibration serving both). Then the `taf` stem (TemporalActive
    Focus) served as phase 4. Last, merged_tower_sites. Returns (the
    launch counts of each path, merged_tower_sites' row)."""
    canon, merged = merged_gen1_models(build_detector, pipeline)
    f32_state = {k: v.clone() for k, v in merged.state_dict().items()}
    runs = {name: pipeline.make_pipeline_kernel(
        m, GEN1_SENSOR, GEN1_INPUT, device=dev, dtype=torch.bfloat16)
        for name, m in (("canonical", canon), ("merged", merged))}
    by_path = {}

    def drive_gen1(run, label, path, n_windows, first):
        state = pipeline.new_state(B, GEN1_SENSOR, device=dev)
        for fn in counters.values():
            fn.launches = 0
        for i, (ev, nv) in enumerate(windows[first:first + n_windows]):
            state, vol = run.stages["encode_transform"](state, ev, nv)
            dets, keep = run.stages["detect"](vol)
            torch.cuda.synchronize()
            if not (torch.isfinite(state).all() and torch.isfinite(dets).all()
                    and dets.shape == (B, 100, 6)):
                raise SystemExit(f"{label} window {i}: non-finite output or "
                                 f"dets {tuple(dets.shape)}")
            log(f"{label} window {i}: kept {int(keep.sum().item())} of "
                f"{int((dets[..., 5] > 0).sum().item())} boxes past conf "
                f"0.3 over {B} streams")
        by_path[path] = {k: fn.launches for k, fn in counters.items()}
        if min(by_path[path][k] for k in (B1, B2)) < n_windows:
            raise SystemExit(f"{label} did not go through B1 and B2: "
                             f"{by_path[path]}")
        return state, vol

    state, vol = drive_gen1(runs["merged"], "merged head path",
                            "gen1_merged", MAIN_WINDOWS, 0)
    with torch.inference_mode():
        rel = maps_rel_l2(merged(vol), canon(vol))
    log(f"merged head against the canonical head, bf16 head maps on the "
        f"same weights, relative L2 per level: "
        + ", ".join(f"{r:.2e}" for r in rel))
    if not all(r < MERGED_BF16_REL for r in rel):
        raise SystemExit(f"merged head maps beyond relative L2 "
                         f"{MERGED_BF16_REL} of the canonical: {rel}")
    planted = planted_fault_rel(merged, canon, vol)
    log(f"the gate against a planted fault (two channels of level 0's reg "
        f"tower layer-1 BatchNorm swapped), relative L2 per level: "
        + ", ".join(f"{r:.2e}" for r in planted))
    if not planted[0] > MERGED_BF16_REL:
        raise SystemExit(f"the planted fault reads {planted[0]:.2e} at "
                         f"level 0, within the gate {MERGED_BF16_REL}")

    fresh = pipeline.new_state(B, GEN1_SENSOR, device=dev)
    quant = pipeline.calibrate_pipeline(runs["merged"], merged, f32_state,
                                        fresh, windows[:2])
    sites = quantize.eligible_sites(canon)
    if set(quant[0]) != set(sites):
        raise SystemExit(f"merged calibration: {len(quant[0])} keys, not "
                         f"the canonical model's {len(sites)} sites")
    canon_scales = pipeline.calibrate_pipeline(
        runs["canonical"], canon, f32_state,
        pipeline.new_state(B, GEN1_SENSOR, device=dev), windows[:2])[0]
    spread = max(abs(quant[0][k] / v - 1) for k, v in canon_scales.items())
    log(f"merged calibration: the canonical model's {len(sites)} site keys, "
        f"ranges within {spread:.2e} (relative) of the canonical "
        f"calibration's")
    int8 = {"merged": pipeline.make_pipeline_kernel(
                merged, GEN1_SENSOR, GEN1_INPUT, device=dev, quant=quant),
            "canonical": pipeline.make_pipeline_kernel(
                canon, GEN1_SENSOR, GEN1_INPUT, device=dev, quant=quant)}
    ctx = int8["merged"].int8          # the timed path's own sites
    per_window = len(ctx.sites) + sum(
        len(v) for _, m in ctx.merged.values() for v in m.sites.values())
    state, vol = drive_gen1(int8["merged"], "merged head int8 path",
                            "gen1_merged_int8", INT8_WINDOWS, 2)
    launched = by_path["gen1_merged_int8"]["int8_conv2d"]
    log(f"merged head int8 path: int8_conv2d launched {launched} times over "
        f"{INT8_WINDOWS} windows ({per_window} a window: {len(ctx.sites)} "
        f"canonical sites, the towers' 12 as "
        f"{per_window - len(ctx.sites)}; the canonical path's "
        f"{len(sites)})")
    if launched != per_window * INT8_WINDOWS:
        raise SystemExit(f"merged int8 path: {launched} launches, not "
                         f"{per_window} x {INT8_WINDOWS}")
    errs = int8_site_errors(merged, vol, ctx)
    errs.update(merged_site_errors(quantize, merged, vol, ctx))
    worst = max(errs, key=errs.get)
    log(f"merged int8 sites against their bf16 convs, relative L2: median "
        f"{sorted(errs.values())[len(errs) // 2]:.4f}, largest "
        f"{errs[worst]:.4f} ({worst}); the merged towers "
        + ", ".join(f"{k}: {v:.4f}" for k, v in errs.items()
                    if isinstance(k, tuple))
        + "; every merged launch bit for bit its twin")
    if not all(1e-4 < e < 0.04 for e in errs.values()):
        raise SystemExit(f"merged int8 sites beyond relative L2 0.04: "
                         f"{errs}")
    rel = head_maps_rel_l2(merged, vol, ctx)
    log(f"merged int8 head maps against bf16, relative L2 per level: "
        + ", ".join(f"{r:.4f}" for r in rel))
    if not all(0 < r < 0.08 for r in rel):
        raise SystemExit(f"merged int8 head maps beyond relative L2 0.08: "
                         f"{rel}")

    ev, nv = windows[0]
    times = {}
    for dtype, pair in (("bf16", runs), ("int8", int8)):
        for name in ("canonical", "merged", "merged", "canonical"):
            run = pair[name]
            det_ms = time_ms(lambda: run.stages["detect"](vol), n=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(10):
                state, _ = run(state, *windows[i % len(windows)])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / 10 * 1e3
            times.setdefault((dtype, name), []).append((det_ms, step_ms))
    for (dtype, name), rows in times.items():
        log(f"GEN1 {dtype} {name} head on {card}: detect "
            + " / ".join(f"{r[0]:.3f}" for r in rows) + " ms, run_step "
            + " / ".join(f"{r[1]:.3f} ms = {B / r[1] * 1e3:.1f}"
                         for r in rows) + " windows/s")
    del runs, int8
    torch.cuda.empty_cache()

    taf = build_detector(2, stem="taf",
                         generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(taf, torch.Generator().manual_seed(1))
    by_path["gen1_taf_stem"] = run_main_path(
        pipeline, counters, windows[:MAIN_WINDOWS], dev, card, model=taf,
        label="taf stem path")
    del taf
    torch.cuda.empty_cache()
    return by_path, merged_tower_sites(quantize, merged.head.width, rate,
                                       card_name)


def run_experimental_trainers(train, build_detector, data, counters, dev,
                              card, card_name):
    """Phase 39: train_family (train_family_that_fits) of taf_swin,
    taf_corr and taf_syn on phase 28's TAF blobs at GEN1, batch
    TREE_BATCH, the configs' widths, bf16 over f32 masters; then
    gen1_train through train.run_train with the merged head and the
    canonical one in turns (ms/step, peak memory; no kernel launched)."""
    out = {exp_type: train_family_that_fits(
        train, exp_type, data["taf_dir"], data["tree"]["labels"], K,
        counters, dev, card, card_name) for exp_type in NEW_FAMILIES}
    rows = {}
    for name in ("canonical", "merged", "merged", "canonical"):
        model = build_detector(2, stem="bfm", train=True,
                               head_merged=name == "merged",
                               generator=torch.Generator().manual_seed(0))
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rep = train.run_train("gen1_train", steps=TRAIN_STEPS,
                              warmup=TRAIN_WARMUP, model=model, device=dev)
        torch.cuda.synchronize()
        if any(fn.launches for fn in counters.values()):
            raise SystemExit(f"gen1_train {name} head launched a kernel")
        if not all(np.isfinite(v) for lo in rep["losses"]
                   for v in lo.values()):
            raise SystemExit(f"gen1_train {name} head: non-finite losses")
        rows.setdefault(name, []).append((rep["ms_per_step"],
                                          rep["peak_bytes"] / 2**30))
        del model, rep
        torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"gen1_train {name} head on {card}: "
            + " / ".join(f"{ms:.2f}" for ms, _ in r) + " ms/step at batch "
            f"{train.TRAIN_CONFIGS['gen1_train']['batch']}, peak memory "
            + " / ".join(f"{gib:.2f}" for _, gib in r) + " GiB")
    out["gen1_train_heads"] = rows
    return out


def mbv2ca_small_step(d, dtype=torch.float32):
    """MBV2CA (width 0.25, 10 classes, 3 x 64 x 64 images, dropout 0) on
    device d in `dtype`: its eval logits, then one SGD(1e-2) step of the
    mean cross-entropy from the seeded weights: (logits, loss, running
    statistics after), on the host."""
    from frlw_evd_tpu_torch.models.detector import init_parameters_
    from frlw_evd_tpu_torch.models.mobilenet import MBV2CA

    model = MBV2CA(3, num_classes=10, width_mult=0.25)
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.drop.rate = 0.0
    model.to(d, dtype)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64, 64, 3))).to(d, dtype)
    y = torch.from_numpy(rng.integers(0, 10, 4)).to(d)
    with torch.no_grad():
        logits = model.eval()(x).cpu()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    loss = torch.nn.functional.cross_entropy(model.train()(x), y)
    loss.backward()
    opt.step()
    stats = {k: v.double().cpu() for k, v in model.state_dict().items()
             if k.endswith(STATS)}
    return logits, loss.item(), stats


def check_new_modules_against_cpu(train, build_detector, dev):
    """Phase 40, card against CPU in f32 with TF32 off at small size:
    phase 37's check (family_small_step) of taf_swin, taf_corr and
    taf_syn (the swin and corr stems, SwinDarknet); phase 19's
    small_train_errors of the small AED with the taf and taf_3d stems and
    with the merged head (losses rtol 2e-4, statistics 1e-5, and in f64
    gradients and parameters 1e-6); MBV2CA's eval logits in f32 within
    1e-4 of their largest magnitude (DET_GATES' score gate, relative),
    its train step's loss within rtol 2e-4
    and statistics within 1e-5 with the network in f64 (in f32 a running
    variance of its 17 blocks read 1.0e-5 apart on an H100 and the CPU,
    the gate's width: as phase 19 holds gradients, f64 tests the
    algorithm)."""
    check_families_against_cpu(train, dev, NEW_FAMILIES)
    for label, kw in (("taf stem", dict(stem="taf")),
                      ("taf_3d stem", dict(stem="taf_3d")),
                      ("merged head", dict(head_merged=True))):
        err = small_train_errors(train, build_detector, dev, **kw)
        log(f"small {label} train step, card vs CPU: " + ", ".join(
            f"{k} {v:.2e}" for k, v in err.items()))
        if any(err[k] > gate for k, gate in SMALL_TRAIN_GATES.items()):
            raise SystemExit(f"small {label} train step: card and CPU "
                             f"disagree beyond {SMALL_TRAIN_GATES}: {err}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c_lo, g_lo = (mbv2ca_small_step(d)[0] for d in ("cpu", dev))
        (_, c_loss, c_st), (_, g_loss, g_st) = (
            mbv2ca_small_step(d, torch.float64) for d in ("cpu", dev))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    # at its init the net's CoordAtt gates (sigmoids near 1/2, two a
    # block) shrink the logits to about 1e-6: held relative to the largest
    logit_err = ((g_lo - c_lo).abs().max() / c_lo.abs().max()).item()
    stat_err = max((g_st[k] - v).abs().max().item() for k, v in c_st.items())
    log(f"MBV2CA small step, card vs CPU: f32 logits err {logit_err:.2e} "
        f"of the largest ({c_lo.abs().max().item():.2e}); f64 network: loss "
        f"rel "
        f"err {abs(g_loss / c_loss - 1):.2e}, statistics err "
        f"{stat_err:.2e} over {len(c_st)} buffers")
    if (logit_err > DET_GATES["score"]
            or abs(g_loss / c_loss - 1) > SMALL_TRAIN_GATES["losses"]
            or stat_err > SMALL_TRAIN_GATES["statistics"]):
        raise SystemExit("MBV2CA small step: card and CPU disagree")


SPATIAL_SHARDS = 4
SPATIAL_WINDOWS = 3
DP_STEPS = 10                 # timed gen1_train steps at world size 1
B3, B5 = "taf_update_leaky_raw", "taf_update_leaky_v2"


def spatial_windows(pipeline, rng, e_per_bin, sensor, n_shards, dev):
    """SPATIAL_WINDOWS windows on the card: a uniform one; a uniform one
    whose events all lie in shard 0's rows (the other shards' rows see
    none, and must age with the frame); an empty one (n_valid 0)."""
    ev, nv = pipeline.synth_events(rng, 1, B, e_per_bin, sensor)
    first = (torch.from_numpy(ev[0]).to(dev), torch.from_numpy(nv[0]).to(dev))
    ev, nv = pipeline.synth_events(rng, 1, B, e_per_bin, sensor)
    ev[0, ..., 1] = np.floor(ev[0, ..., 1]) % (sensor[0] // n_shards)
    second = (torch.from_numpy(ev[0]).to(dev),
              torch.from_numpy(nv[0]).to(dev))
    empty = (first[0].clone(), torch.zeros_like(first[1]))
    return [first, second, empty]


def _sharded_run(counters, steps, shards, windows, compare):
    """Run the shards' steps over the windows, one shard after another,
    each window's launches counted from 0 just before its shards and read
    just after (the unsharded reference runs outside the count); after
    each window `compare(window index, shard outputs)`. Returns the
    launches summed over the windows."""
    total = Counter()
    for i, (ev, nv) in enumerate(windows):
        for fn in counters.values():
            fn.launches = 0
        outs = [step(shards[s], ev, nv) for s, step in enumerate(steps)]
        torch.cuda.synchronize()
        total.update({k: fn.launches for k, fn in counters.items()})
        shards[:] = [o[0] if isinstance(o, tuple) else o for o in outs]
        compare(i, outs)
    return {k: total[k] for k in counters}


def run_spatial_steps(enc, pipeline, counters, dev, card):
    """Phase 41: parallel/spatial.py at full width, the shards run one
    after another on the card. gen4 p64 (512x640, B = 128, E = 65536,
    K = 8) in SPATIAL_SHARDS row shards, raw (B1 in the p64 order, then
    B3) and sorted (the plain sorted histogram, then B5), over
    spatial_windows: each shard's state and folded volume equal to the
    unsharded step's rows bit for bit, B1 and B3 or B5 launched
    SPATIAL_SHARDS times a window; device ms of the shards against the
    unsharded step. GEN1 (B = 128, E = 16384, the unpacked K = 8 queue)
    through make_spatial_taf_step with B6, and the 2-D layout (2 batch
    halves x 2 row shards), each bit for bit the unsharded step. Returns
    each sharded path's launches."""
    from frlw_evd_tpu_torch.parallel import spatial

    H, W = GEN4_SENSOR
    n = SPATIAL_SHARDS
    by_path = {}
    windows = spatial_windows(pipeline, np.random.default_rng(12), E4,
                              GEN4_SENSOR, n, dev)
    for scatter, name, need in (("pallas", "spatial_gen4_raw", (B1, B3)),
                                ("sorted", "spatial_gen4_sorted", (B5,))):
        ref = enc.p64_init_state(B, H, W, K, device=dev)
        shards = [spatial.shard_taf_state_p64(ref, n, s) for s in range(n)]
        steps = [spatial.make_spatial_taf_step_p64(H, W, n, s,
                                                   scatter=scatter)
                 for s in range(n)]
        refs = []
        for ev, nv in windows:
            ref, vol = enc.taf_stream_step_kernel_p64(
                ref, ev, nv, height=H, width=W, scatter=scatter,
                fold_output=True)
            refs.append((ref.clone(), vol))

        def compare(i, outs):
            state = torch.cat([o[0] for o in outs], 1)
            vol = torch.cat([o[1] for o in outs], 1)
            if not (torch.equal(state, refs[i][0])
                    and torch.equal(vol, refs[i][1])):
                raise SystemExit(
                    f"{name} window {i}: shards differ from the unsharded "
                    f"step by {(state - refs[i][0]).abs().max().item():.3e}"
                    f" (state), {(vol.float() - refs[i][1].float()).abs()
                                 .max().item():.3e} (volume)")

        launches = _sharded_run(counters, steps, shards, windows, compare)
        by_path[name] = launches
        if any(launches[k] != n * len(windows) for k in need):
            raise SystemExit(f"{name}: {need} must launch {n} times a "
                             f"window: {launches}")
        ev, nv = windows[0]
        ms_sharded = time_ms(lambda: [step(shards[s], ev, nv)
                                      for s, step in enumerate(steps)], n=5)
        ms_whole = time_ms(lambda: enc.taf_stream_step_kernel_p64(
            ref, ev, nv, height=H, width=W, scatter=scatter,
            fold_output=True), n=5)
        log(f"{name} on {card}: {n} shards of {H // n} rows bit for bit "
            f"the unsharded step on {len(windows)} windows (one with events "
            f"in shard 0's rows only, one empty); {ms_sharded:.3f} ms a "
            f"window for the {n} shards one after another against "
            f"{ms_whole:.3f} ms unsharded; launches "
            + ", ".join(f"{k} {launches[k]}" for k in need))
        del ref, refs, shards
        torch.cuda.empty_cache()

    H, W = GEN1_SENSOR
    windows = spatial_windows(pipeline, np.random.default_rng(13), E,
                              GEN1_SENSOR, n, dev)
    refs, ref = [], torch.full((B, H, W, 2, K), -6000.0, device=dev)
    for ev, nv in windows:
        refs.append(enc.taf_stream_step(ref, ev, nv, use_mxu=True).clone())
    for name, n_b, n_h in (("spatial_gen1", 1, n), ("spatial_gen1_2d", 2, 2)):
        whole = torch.full((B, H, W, 2, K), -6000.0, device=dev)
        tiles = [(b, h) for b in range(n_b) for h in range(n_h)]
        rows = [slice(b * B // n_b, (b + 1) * B // n_b) for b, _ in tiles]
        shards = [spatial.shard_taf_state(whole[r], n_h, h)
                  for r, (_, h) in zip(rows, tiles)]
        base = [spatial.make_spatial_taf_step(H, n_h, h, use_mxu=True)
                for _, h in tiles]
        steps = [(lambda st, ev, nv, f=f, r=r: f(st, ev[r].contiguous(),
                                                 nv[r].contiguous()))
                 for f, r in zip(base, rows)]

        def compare(i, outs):
            got = torch.cat([torch.cat(outs[b * n_h:(b + 1) * n_h], 1)
                             for b in range(n_b)], 0)
            if not torch.equal(got, refs[i]):
                raise SystemExit(f"{name} window {i}: tiles differ from the "
                                 f"unsharded step by "
                                 f"{(got - refs[i]).abs().max().item():.3e}")

        launches = _sharded_run(counters, steps, shards, windows, compare)
        by_path[name] = launches
        if launches[B6] != len(tiles) * len(windows):
            raise SystemExit(f"{name}: B6 must launch once a tile a window: "
                             f"{launches}")
        ev, nv = windows[0]
        ms_sharded = time_ms(lambda: [step(shards[s], ev, nv)
                                      for s, step in enumerate(steps)], n=5)
        log(f"{name} on {card}: {n_b} x {n_h} tiles bit for bit the "
            f"unsharded step on {len(windows)} windows; {ms_sharded:.3f} ms "
            f"a window for the tiles one after another; B6 {launches[B6]}")
    ev, nv = windows[0]
    ms_whole = time_ms(lambda: enc.taf_stream_step(ref, ev, nv,
                                                   use_mxu=True), n=5)
    log(f"unsharded GEN1 step on {card}: {ms_whole:.3f} ms a window")
    del refs, ref, windows
    torch.cuda.empty_cache()
    return by_path


def run_data_parallel(data, counters, dev, card, synthetic_train):
    """Phase 42: data-parallel training (parallel/dist.py, check.py).
    World size 1 under NCCL, in a subprocess with torchrun's environment:
    gen1_train through run_train (bf16 over f32 masters), ms/step beside
    phase 17's. World size 2 over gloo, both ranks on this card (NCCL
    refuses two ranks on one GPU): one Adam step of gen1_train's AED
    (TF32 off, dropout 0) at 32 rows a rank against world size 1 in this
    process on the 64 rows, in f32 and in f64: the f32 losses within rtol
    2e-4 and BatchNorm statistics within 1e-5; with the network in f64
    the parameters after the step within 1e-5 and the gradients within
    1e-6 of each leaf's largest (phase 19's gates; in f32 Adam's first
    update moves an element whose gradient is at its rounding noise by
    +-lr, so the f32 parameters are printed, not gated). Then cli.train at world
    size 2 over gloo for one Trainer epoch of taf_bfm on phase 28's TAF
    blobs at batch TREE_BATCH: the checkpoint written once, every COCO
    stat finite, no kernel launched."""
    from frlw_evd_tpu_torch.parallel import check

    out = WORK / "dp"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    check.spawn(1, ["--out", str(out / "w1"), "--device", "cuda",
                    "--cases", "", "--time_gen1", str(DP_STEPS)],
                timeout=600)
    w1 = torch.load(out / "w1" / "rank0.pt", weights_only=False)
    rep = w1["time_gen1"]
    if not all(np.isfinite(v) for lo in rep["losses"] for v in lo.values()):
        raise SystemExit(f"world 1 gen1_train: non-finite losses")
    log(f"gen1_train at world size 1 under NCCL on {card}: "
        f"{rep['ms_per_step']:.2f} ms/step at batch {rep['batch']}, "
        f"{rep['windows_per_s']:.1f} windows/s, peak memory "
        f"{rep['peak_bytes'] / 2**30:.2f} GiB (the group BatchNorm's two "
        f"all-reduces a BatchNorm, one gradient all-reduce a step); phase "
        f"17 without a group {synthetic_train['ms_per_step']:.2f} ms/step "
        f"(subprocess {time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    check.spawn(2, ["--out", str(out / "w2"), "--device", "cuda",
                    "--backend", "gloo", "--cases", "gen1"],
                local_rank_zero=True, timeout=600)
    ranks = [torch.load(out / "w2" / f"rank{r}.pt", weights_only=False)
             ["gen1"] for r in range(2)]
    wall = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    want = check.run_case("gen1", dev)
    torch.cuda.synchronize()
    if any(fn.launches for fn in counters.values()):
        raise SystemExit("the world-1 gen1 step launched a kernel")
    err = {"losses": 0.0, "statistics": 0.0, "parameters": 0.0,
           "gradients": 0.0, "residue": 0.0, "f32_parameters": 0.0}
    top = max(g.abs().max().item() for g in want["f64"]["grads"].values())
    for got in ranks:
        f32, f64 = got["f32"], got["f64"]
        err["losses"] = max(err["losses"], max(
            abs(f32["losses"][k] / v - 1)
            for k, v in want["f32"]["losses"].items() if v))
        for k, v in want["f32"]["state"].items():
            key = "statistics" if k.endswith(STATS) else "f32_parameters"
            err[key] = max(err[key], (f32["state"][k] - v).abs().max().item())
        for k, v in want["f64"]["state"].items():
            if not k.endswith(STATS):
                err["parameters"] = max(err["parameters"], (
                    f64["state"][k] - v).abs().max().item())
        for k, g in want["f64"]["grads"].items():
            m, diff = g.abs().max().item(), (f64["grads"][k] - g).abs().max()
            if m > GRAD_FLOOR * top:
                err["gradients"] = max(err["gradients"], diff.item() / m)
            else:
                err["residue"] = max(err["residue"], diff.item() / top)
    log(f"world size 2 over gloo on {card} against world size 1 on the 64 "
        f"rows (one Adam step of gen1_train's AED, dropout 0, TF32 off): "
        f"in f32 losses {err['losses']:.2e} (rtol 2e-4), statistics "
        f"{err['statistics']:.2e} (1e-5), parameters "
        f"{err['f32_parameters']:.2e} (no gate: Adam's first update moves "
        f"an element whose gradient is at its f32 noise by +-lr); in f64 "
        f"parameters {err['parameters']:.2e} (1e-5), gradients "
        f"{err['gradients']:.2e} of each leaf's largest (1e-6), residue "
        f"{err['residue']:.2e} (1e-12); both ranks {wall:.1f} s")
    if (err["losses"] > 2e-4 or err["statistics"] > 1e-5
            or err["parameters"] > 1e-5 or err["gradients"] > 1e-6
            or err["residue"] > 1e-12):
        raise SystemExit(f"world 2 against world 1: {err}")

    cli = (f"--exp_type taf_bfm --dataset gen1 --batch_size {TREE_BATCH} "
           f"--event_volume_bins {K} --max_epoch_to_stop 1 "
           f"--data_path {data['taf_dir']} "
           f"--bbox_path {data['tree']['labels']} "
           f"--log_path {out / 'log'} --exp_name dp2 --dist_backend gloo")
    t0 = time.perf_counter()
    check.spawn(2, ["--out", str(out / "cli"), "--device", "cuda",
                    "--backend", "gloo", "--cases", "cli", "--cli", cli],
                local_rank_zero=True, timeout=900)
    wall = time.perf_counter() - t0
    ranks = [torch.load(out / "cli" / f"rank{r}.pt", weights_only=False)
             ["cli"] for r in range(2)]
    for r in ranks:
        if any(r["launches"].values()):
            raise SystemExit(f"the world-2 Trainer launched a kernel: "
                             f"{r['launches']}")
        if r["stats"] is None or not all(np.isfinite(r["stats"])):
            raise SystemExit(f"world-2 COCO stats: {r['stats']}")
    ckpts = sorted(os.listdir(out / "log" / "dp2" / "checkpoints"))
    if "last_epoch" not in ckpts or ranks[0]["stats"] != ranks[1]["stats"]:
        raise SystemExit(f"world-2 epoch: checkpoints {ckpts}, stats "
                         f"{[r['stats'] for r in ranks]}")
    h = ranks[0]["history"][0]
    log(f"cli.train at world size 2 over gloo on {card}: {h['steps']} "
        f"steps at global batch {TREE_BATCH} ({TREE_BATCH // 2} a rank), "
        f"{h['wall_s'] / h['steps'] * 1e3:.1f} ms/step, loader wait "
        f"{h['loader_wait_s'] / h['wall_s']:.1%}; COCO stats "
        + ", ".join(f"{v:.4f}" for v in ranks[0]["stats"])
        + f"; checkpoints {ckpts}; no kernel launched; {wall:.1f} s")
    shutil.rmtree(out, ignore_errors=True)


EXPORT_TIMED = 10
INT8_SITES_GEN1 = 61


def run_export(counters, dev, card):
    """Phase 43: tools/export_model.py in a subprocess at B = 128 on phase
    22's AED (int8_gen1_model: the full-width GEN1 taf_bfm AED, weights
    spread so that boxes pass conf 0.3), saved as a checkpoint, bf16 and
    --fuse --int8, each with --check; then each .pt2 loaded here: the
    int8 program launches int8_conv2d INT8_SITES_GEN1 times a call, and
    keep and dets match the live step built here the same way (keep
    equal, dets within atol 1e-5); windows/s of the loaded program and
    the live step, EXPORT_TIMED calls each, in turns (live, loaded,
    loaded, live). Returns the launches of the loaded programs' calls."""
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.models import build_detector
    from frlw_evd_tpu_torch.tools import export_model as ex

    out = WORK / "export"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ckpt = str(out / "gen1_aed")
    torch.save({"model": int8_gen1_model(build_detector, pipeline)
                .state_dict()}, ckpt)
    by_path = {}
    vol = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (B, *GEN1_INPUT, 2 * K)).astype(np.float32)).to(dev)
    exports = {name: flags for name, flags in (
        ("export_bf16", []), ("export_int8", ["--fuse", "--int8"]))}
    procs, t_start = {}, time.perf_counter()
    for name, flags in exports.items():     # both exports at once
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "frlw_evd_tpu_torch.tools.export_model",
             "--out", str(out / f"{name}.pt2"), "--exp_type", "taf_bfm",
             "--dataset", "gen1", "--batch", str(B), "--ckpt", ckpt,
             "--check", *flags], cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, flags in exports.items():
        path = out / f"{name}.pt2"
        stdout, stderr = procs[name].communicate(timeout=900)
        if (procs[name].returncode != 0
                or "roundtrip check ok" not in stdout):
            raise SystemExit(f"{name} failed:\n{stdout}\n{stderr}")
        export_s = time.perf_counter() - t_start
        cfg = ex.config("taf_bfm", "gen1")
        live, shape, n_sites = ex.build_serving_fn(
            cfg, ex.build_model(cfg, ckpt), B, device=dev,
            fuse=bool(flags), int8=bool(flags))
        program = torch.export.load(str(path)).module()
        with torch.no_grad():
            want = live(vol)
            for fn in counters.values():
                fn.launches = 0
            got = program(vol)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
        by_path[name] = launches
        sites = INT8_SITES_GEN1 if flags else 0
        if n_sites != sites or launches["int8_conv2d"] != sites or any(
                v for k, v in launches.items() if k != "int8_conv2d"):
            raise SystemExit(f"{name}: {n_sites} sites, launches {launches}")
        err = (got[0] - want[0]).abs().max().item()
        if (not torch.equal(got[1], want[1]) or not err <= 1e-5
                or not 0 < int(want[1].sum()) < int((want[0][..., 5] > 0)
                                                    .sum())):
            raise SystemExit(f"{name}: loaded program against the live "
                             f"step: dets {err}, keep equal "
                             f"{torch.equal(got[1], want[1])}, "
                             f"{int(want[1].sum())} kept")
        rates = {"live": [], "loaded": []}
        with torch.no_grad():
            for which in ("live", "loaded", "loaded", "live"):
                fn = live if which == "live" else program
                fn(vol)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EXPORT_TIMED):
                    fn(vol)
                torch.cuda.synchronize()
                rates[which].append(B * EXPORT_TIMED
                                    / (time.perf_counter() - t0))
        log(f"{name} on {card}: exported and checked in a subprocess (the "
            f"two at once) within {export_s:.1f} s ({path.stat().st_size / 1e6:.1f} MB); loaded "
            f"program {' / '.join(f'{r:.1f}' for r in rates['loaded'])} "
            f"windows/s against the live step "
            f"{' / '.join(f'{r:.1f}' for r in rates['live'])} (B = {B}, in "
            f"turns); int8_conv2d {launches['int8_conv2d']} a call; dets "
            f"within {err:.1e}, keep equal ({int(want[1].sum())} kept)")
        del live, program, want, got
        torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return by_path


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
    synthetic_train = {}
    for n, config in ((17, "gen1_train"), (18, "gen4_train")):
        synthetic_train[config] = phase(n, config, run_train_config, train,
                                        build_detector, counters, config,
                                        dev, card, name)
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
    torch.cuda.empty_cache()
    data = phase(28, "data path", run_data_path, counters, dev, card,
                 synthetic_train["gen1_train"])
    torch.cuda.empty_cache()
    by_path["stream_infer"], b6_b1 = phase(
        29, "stream_infer", run_stream_infer, enc, pipeline, data, counters,
        dev, card, rate)
    rows["scatter_cnt_tsum_pallas_sorted"]["stream_infer_b1"] = b6_b1
    phase(30, "data path small, card vs CPU", check_data_path_against_cpu,
          pipeline, build_detector, dev)
    ev_dir = phase(31, "EV, ECI and SAE generators", run_generators, data,
                   counters, dev, card)
    phase(32, "Trainer: basic on EV blobs, yolox_taf_bfm",
          run_trainer_families, train, data, ev_dir, counters, dev, card,
          name, synthetic_train["gen1_train"])
    torch.cuda.empty_cache()
    phase(33, "gen1_train four ways", run_train_four_ways, train,
          build_detector, counters, dev, card, name)
    torch.cuda.empty_cache()
    windows = device_windows(pipeline, np.random.default_rng(8), E,
                             GEN1_SENSOR, dev)
    by_path["gen1_yolox"] = phase(34, "yolox GEN1 path", run_yolox_path,
                                  pipeline, build_detector, counters,
                                  windows, dev, card)
    del windows
    torch.cuda.empty_cache()
    phase(35, "Trainer: yolov3_taf_bfm at 640x640", run_yolov3_trainer,
          train, data, counters, dev, card, name)
    phase(36, "Trainer: red, convlstm, recconv", run_recurrent_trainers,
          train, data, ev_dir, counters, dev, card, name)
    phase(37, "five families small, card vs CPU",
          check_families_against_cpu, train, dev)
    torch.cuda.empty_cache()
    windows = (device_windows(pipeline, np.random.default_rng(9), E,
                              GEN1_SENSOR, dev)
               + device_windows(pipeline, np.random.default_rng(10), E,
                                GEN1_SENSOR, dev))
    merged_paths, rows["int8_conv2d"]["merged"] = phase(
        38, "GEN1 merged head and taf stem", run_merged_head_path, pipeline,
        quantize, build_detector, counters, windows, dev, card, rate, name)
    by_path.update(merged_paths)
    del windows
    torch.cuda.empty_cache()
    phase(39, "Trainer: taf_swin, taf_corr, taf_syn; merged gen1_train",
          run_experimental_trainers, train, build_detector, data, counters,
          dev, card, name)
    phase(40, "new stems, SwinDarknet, MBV2CA, merged head small, card vs "
          "CPU", check_new_modules_against_cpu, train, build_detector, dev)
    torch.cuda.empty_cache()
    by_path.update(phase(41, "spatial TAF steps", run_spatial_steps, enc,
                         pipeline, counters, dev, card))
    torch.cuda.empty_cache()
    phase(42, "data-parallel training", run_data_parallel, data, counters,
          dev, card, synthetic_train["gen1_train"])
    torch.cuda.empty_cache()
    by_path.update(phase(43, "export", run_export, counters, dev, card))
    shutil.rmtree(WORK, ignore_errors=True)

    # entry: (wrapper, paths that launch it in the entry's cell order (B1)
    # or at all, the first being the one at the entry's shape whose
    # launches the entry reports, source, TPU kernel)
    meta = {
        "scatter_cnt_tsum": ("scatter_cnt_tsum",
                             ("gen1", "gen1_int8", "gen1_packed_pallas",
                              "gen4_packed_pallas", "gen4_folded_pallas",
                              "gen1_taf_packed", "gen4_taf_packed",
                              "gen1_yolox", "gen1_merged",
                              "gen1_merged_int8", "gen1_taf_stem"),
                             "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                             "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "scatter_cnt_tsum_p64": ("scatter_cnt_tsum",
                                 ("gen4", "gen4_bfm_p64_kernel",
                                  "gen4_int8", "gen4_p64k4_raw",
                                  "spatial_gen4_raw"),
                                 "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                                 "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "scatter_cnt_tsum_pallas_sorted": (
            "scatter_cnt_tsum_pallas_sorted",
            ("gen4_precise", "gen4_p64k4_precise", "gen1_unpacked_mxu",
             "gen1_packed_precise", "gen1_packed_mxu", "gen1_taf_dense",
             "gen1_taf_p64", "stream_infer", "spatial_gen1",
             "spatial_gen1_2d"),
            "frlw_evd_tpu_torch/csrc/scatter_sorted.cu",
            "frlw_evd_tpu/encode/pallas_scatter.py:343"),
        "scatter_cnt_tsum_pallas": ("scatter_cnt_tsum_pallas", ("gen1_b8",),
                                    "frlw_evd_tpu_torch/csrc/scatter_dense.cu",
                                    "frlw_evd_tpu/encode/pallas_scatter.py:67"),
        "taf_update_leaky": ("taf_update_leaky",
                             ("gen1", "gen1_int8", "gen4_folded_pallas",
                              "gen4_folded_sorted", "gen4_p64k4_raw",
                              "gen4_p64k4_precise", "gen4_p64k4_sorted",
                              "gen1_yolox", "gen1_merged",
                              "gen1_merged_int8", "gen1_taf_stem"),
                             "frlw_evd_tpu_torch/csrc/taf_update.cu",
                             "frlw_evd_tpu/encode/pallas_update.py:37"),
        "taf_update_leaky_raw": ("taf_update_leaky_raw",
                                 ("gen4", "gen4_bfm_p64_kernel",
                                  "gen4_int8", "spatial_gen4_raw"),
                                 "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                 "frlw_evd_tpu/encode/pallas_update.py:233"),
        "taf_update_leaky_v2": ("taf_update_leaky_v2",
                                ("gen4_sorted", "gen4_precise",
                                 "spatial_gen4_sorted"),
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
        "int8_conv2d": ("int8_conv2d", ("gen1_int8", "gen4_int8",
                                        "gen1_merged_int8", "export_int8"),
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
                                               "gen4", "merged",
                                               "stream_infer_b1")
                           if k in row}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
