#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; no phase catches and continues):
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel of both serving paths from frlw_evd_tpu_torch/csrc with nvcc
     for sm_90a, all sources compiled in parallel;
  2. kernel B1 (scatter_cnt_tsum) against its plain twin at the full GEN1
     shape (B = 128 streams, E = 16384 event slots), uniform and skewed
     events with bursty n_valid: counts exact, t-sums within the f32
     reordering bound cnt^2 * 2^-23 (the kernel's atomics add in a
     run-dependent order);
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
     (B = 128, E = 65536, 512x640), uniform and skewed, as in phase 2;
  7. kernel B3 (taf_update_leaky_raw) against its twin at full gen4 shape
     with one frozen stream: state exact, volume within one bf16 ulp;
  8. kernels B4 (bfm_chain_apply_folded) and B7 (bfm_chain_apply) against
     their twins on all 128 streams of the gen4 volume: atol 1e-2 + rtol
     1e-2 (a bf16-rounded intermediate may round the other way), B4's pad
     channels exactly zero;
  9. the 1 Mpx (gen4_taf) main path at full width: AED with the bfm_folded
     stem, 7 classes, bf16, B = 128, E = 65536, 512x640, 4 windows carrying
     state; B1, B3 and B4 must launch on every window; per-stage times,
     windows/s and peak memory;
 10. the bfm_p64_kernel stem (fold_output=False, chain in B7) at full gen4
     shape for 3 windows: B7 must launch;
 11. the 1 Mpx slice on a small input against the same slice on the CPU,
     f32 without TF32 (see check_small_p64_against_cpu for the gates).
Every phase that drives a path sets all launch counts to 0 just before it
and reads them just after. It prints one {"kernels": [...]} JSON line, one
entry per kernel and B1 once per cell order, each entry's launches and
times from one path (the others that launch it under launches_by_path),
and the nvidia-smi line before its last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

GEN1_SENSOR, GEN1_INPUT = (240, 304), (256, 320)
GEN4_SENSOR = (512, 640)               # gen4_taf: input == sensor
B, E, E4, K = 128, 16384, 65536, 8
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
# exp2 and reciprocal run on the special function units: 16 results per
# clock per SM on compute capability 9.0 against 128 f32 FMAs (CUDA C++
# Programming Guide, arithmetic instruction throughput), so the SFU rate is
# the f32 FMA rate in FLOP/s over 16. silu(u) = u / (1 + exp(-u)) with IEEE
# expf and division needs one of each, so 2 SFU results per silu at least.
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


def check_scatter(enc, ev_sets, dev, rate, sensor, layout):
    """Phases 2 and 6: B1 vs its twin in one cell order; times on the
    uniform set."""
    H, W = sensor
    B = ev_sets["uniform"][0].shape[0]
    kw = dict(height=H, width=W, layout=layout)
    err = 0.0
    for name, (ev, nv) in ev_sets.items():
        cnt, tsum, anyv = enc.scatter_cnt_tsum(ev, nv, **kw)
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
            f"{diff.max().item():.3e}")
        del cnt, tsum, p_cnt, p_tsum
    ev, nv = ev_sets["uniform"]
    P = H * W * 2
    ms = time_ms(lambda: enc.scatter_cnt_tsum(ev, nv, **kw))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_plain(ev, nv, **kw))
    # library yardstick: one index_add_ of the [1, t - 1] columns
    from frlw_evd_tpu_torch.encode.scatter import event_cells
    idx, tv, valid = event_cells(ev, nv, H, W, layout)
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
                library_ms=library_ms, bound_ms=bytes_moved / rate * 1e3,
                bound_by="bytes")


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
                library_ms=None, bound_ms=bytes_moved / rate * 1e3,
                bound_by="bytes")


def run_main_path(pipeline, counters, windows, dev, card):
    """Phase 4: the GEN1 serving path at full width; returns the launch
    counts of its run."""
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(2, stem="bfm",
                           generator=torch.Generator().manual_seed(0))
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
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


def check_chains(stem_chain, dev, card_name):
    """Phase 8: B4 and B7 vs their twins at full gen4 shape, bf16 volume,
    weights of a seeded full-width stem. Tolerance atol 1e-2 + rtol 1e-2:
    a bf16-rounded intermediate may round the other way where the twin
    sums in another order; B4's pad channels exactly zero.

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
    params = {k: v.to(dev, torch.bfloat16)
              for k, v in stem.chain_params().items()}
    gd = torch.Generator(device=dev).manual_seed(1)
    vol = torch.rand(B, H2, W2 * 64, device=dev, generator=gd).to(
        torch.bfloat16)
    n_sub = B * H2 * W2 * 4
    products_s = (2 * stem_chain.MACS_PER_SUBPIXEL * n_sub
                  / bf16_tensor_flops(card_name))
    silu_s = (SFU_PER_SILU * stem_chain.SILU_PER_SUBPIXEL * n_sub
              / (f32_flops(card_name) / 16))
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
        log(f"{name}: matches its twin on all {B} streams, max |d| "
            f"{max_err:.3e}, {active:.1%} of outputs > 0")
        del out, want, err
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fn(*args, **kw))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from frlw_evd_tpu_torch import encode as enc
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.kernels import _build
    from frlw_evd_tpu_torch.models import stem_chain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    counters = {"scatter_cnt_tsum": enc.scatter_cnt_tsum,
                "taf_update_leaky": enc.taf_update_leaky,
                "taf_update_leaky_raw": enc.taf_update_leaky_raw,
                "bfm_chain_apply_folded": stem_chain.bfm_chain_apply_folded,
                "bfm_chain_apply": stem_chain.bfm_chain_apply}

    t0 = time.perf_counter()
    build_logs = _build.build()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(0)
    windows = device_windows(pipeline, rng, E, GEN1_SENSOR, dev)
    ev_sets = {"uniform": windows[0], "skewed": windows[2]}
    rows = {"scatter_cnt_tsum": check_scatter(enc, ev_sets, dev, rate,
                                              GEN1_SENSOR, "folded"),
            "taf_update_leaky": check_update(enc, ev_sets, dev, rate)}
    by_path = {"gen1": run_main_path(pipeline, counters,
                                     windows[:MAIN_WINDOWS], dev, card)}
    check_small_against_cpu(pipeline, dev)
    del windows, ev_sets
    torch.cuda.empty_cache()

    windows = device_windows(pipeline, rng, E4, GEN4_SENSOR, dev)
    ev_sets = {"uniform": windows[0], "skewed": windows[2]}
    rows["scatter_cnt_tsum_p64"] = check_scatter(enc, ev_sets, dev, rate,
                                                 GEN4_SENSOR, "p64")
    rows["taf_update_leaky_raw"] = check_update_raw(enc, ev_sets, dev, rate)
    torch.cuda.empty_cache()
    rows.update(check_chains(stem_chain, dev, name))
    torch.cuda.empty_cache()
    by_path["gen4"] = run_gen4_path(pipeline, counters, windows, dev, card)
    torch.cuda.empty_cache()
    by_path["gen4_bfm_p64_kernel"] = run_p64_kernel_config(
        pipeline, counters, windows[:3], dev)
    check_small_p64_against_cpu(pipeline, dev)

    # entry: (wrapper, paths that launch it at the entry's shape, the first
    # being the one whose launches the entry reports, source, TPU kernel)
    meta = {
        "scatter_cnt_tsum": ("scatter_cnt_tsum", ("gen1",),
                             "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                             "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "scatter_cnt_tsum_p64": ("scatter_cnt_tsum",
                                 ("gen4", "gen4_bfm_p64_kernel"),
                                 "frlw_evd_tpu_torch/csrc/scatter_hist.cu",
                                 "frlw_evd_tpu/encode/pallas_scatter.py:303"),
        "taf_update_leaky": ("taf_update_leaky", ("gen1",),
                             "frlw_evd_tpu_torch/csrc/taf_update.cu",
                             "frlw_evd_tpu/encode/pallas_update.py:37"),
        "taf_update_leaky_raw": ("taf_update_leaky_raw",
                                 ("gen4", "gen4_bfm_p64_kernel"),
                                 "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                 "frlw_evd_tpu/encode/pallas_update.py:233"),
        "bfm_chain_apply_folded": ("bfm_chain_apply_folded", ("gen4",),
                                   "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                                   "frlw_evd_tpu/models/pallas_stem.py:98"),
        "bfm_chain_apply": ("bfm_chain_apply", ("gen4_bfm_p64_kernel",),
                            "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                            "frlw_evd_tpu/models/pallas_stem.py:59"),
    }
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
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
