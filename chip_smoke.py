#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero; no phase catches and continues):
  1. print the card's name and power limit (nvidia-smi), then build every
     kernel from frlw_evd_tpu_torch/csrc with nvcc for sm_90a, all
     sources compiled in parallel;
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
     f32 without TF32 (see check_small_p64_against_cpu for the gates);
 12. kernel B6 (scatter_cnt_tsum_pallas_sorted) against its twin at the
     full gen4 shape on the p64 cells of the uniform and skewed windows:
     counts exact, t-sums within cnt^2 * 2^-24, two launches bitwise equal;
     times with and without the sort, and of a one-cell set;
 13. kernel B5 (taf_update_leaky_v2) against its twin at full gen4 shape
     with one frozen stream (state exact, volume within one bf16 ulp), and
     against B3 on the same B1 planes, bit for bit;
 14. kernel B8 (scatter_cnt_tsum_pallas) on its own path, the folded cells
     of the GEN1 uniform and skewed windows, then against its twin: counts
     exact, t-sums within cnt^2 * 2^-23; timed beside B1 and index_add_;
 15. the 1 Mpx path through the new entries at full width: make_pipeline_p64
     (scatter="sorted") with the bfm_folded AED for 3 windows carrying
     state, then taf_stream_step_kernel_p64(precise=True) feeding the same
     detect stage for 3 windows; B5 and B4 must launch on every window of
     both, B6 on every window of the second; per-stage times, windows/s;
 16. the precise and sorted p64 steps and the precise GEN1 step on a small
     input, card against CPU, with phase 11's state and volume gates.
Every phase that drives a path sets all launch counts to 0 just before it
and reads them just after, and each phase prints its wall seconds. It
prints one {"kernels": [...]} JSON line, one entry per kernel and B1 once
per cell order, each entry's launches and times from one path (every path
that launches it under launches_by_path), and the nvidia-smi line before
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
    library_ms = index_add_ms(*enc.event_cells(ev, nv, H, W, layout), P)
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


def check_pair_sorted(enc, ev_sets, rate):
    """Phase 12: B6 vs its twin at full gen4 shape on the p64 cells of the
    uniform and skewed windows. Counts exact; t-sums within cnt^2 * 2^-24
    (the kernel sums each run in f32 in sorted order, the twin in f64 and
    rounds once); two launches bitwise equal. Times on the uniform set: the
    wrapper as the step calls it (sort, gather, zero fill, kernel), the sort
    alone, the twin, index_add_ and a one-cell set (every event of a stream
    in one cell: one thread walks the whole run)."""
    H, W = GEN4_SENSOR
    size = H * W * 2
    err, cells = 0.0, {}
    for name, (ev, nv) in ev_sets.items():
        idx, tv, valid = cells[name] = enc.event_cells(ev, nv, H, W, "p64")
        cnt, tsum = enc.scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
        cnt2, tsum2 = enc.scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
        p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_sorted_plain(
            idx, tv, valid, size)
        torch.cuda.synchronize()
        same = torch.equal(cnt, cnt2) and torch.equal(tsum, tsum2)
        if not same or not torch.equal(cnt, p_cnt):
            raise SystemExit(f"B6 {name}: launches bitwise equal: {same}, "
                             f"counts equal to the twin's: "
                             f"{torch.equal(cnt, p_cnt)}")
        diff = (tsum - p_tsum).abs()
        if not bool((diff <= p_cnt * p_cnt * 2.0 ** -24).all()):
            raise SystemExit(f"B6 {name}: t-sum error {diff.max().item()} "
                             f"beyond cnt^2 * 2^-24")
        err = max(err, diff.max().item())
        log(f"B6 {name}: counts exact ({int(p_cnt.sum().item())} events), "
            f"max |dtsum| {diff.max().item():.3e}, two launches bitwise "
            f"equal")
        del cnt, tsum, cnt2, tsum2, p_cnt, p_tsum, diff
    idx, tv, valid = cells["uniform"]
    ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(idx, tv, valid,
                                                            size))
    key = torch.where(valid, idx, size)
    sort_ms = time_ms(lambda: torch.sort(key, dim=1, stable=True))
    sort_gather_ms = time_ms(lambda: torch.gather(
        tv, 1, torch.sort(key, dim=1, stable=True)[1]))
    sorted_hist_ms = time_ms(lambda: enc.scatter_cnt_tsum_sorted(
        idx, tv, valid, size, False))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted_plain(
        idx, tv, valid, size), n=5)
    library_ms = index_add_ms(idx, tv, valid, size)
    one = torch.full_like(idx, 1234)
    cnt, _ = enc.scatter_cnt_tsum_pallas_sorted(one, tv, valid, size)
    if not torch.equal(cnt[:, 1234], valid.sum(1).float()):
        raise SystemExit("B6 one-cell set: wrong count")
    one_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_sorted(
        one, tv, valid, size), n=3, warm=1)
    bytes_moved = idx.numel() * (4 + 4 + 1) + 2 * idx.shape[0] * size * 4
    bound_ms = bytes_moved / rate * 1e3
    log(f"B6: {ms:.3f} ms with the sort and the zero fill (sort alone "
        f"{sort_ms:.3f} ms, sort + gather {sort_gather_ms:.3f} ms, so the "
        f"key, zero fill and kernel {ms - sort_gather_ms:.3f} ms), one-cell "
        f"set {one_ms:.3f} ms; twin {plain_ms:.3f} ms; index_add_ "
        f"{library_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes); the plain "
        f"sorted histogram (scatter='sorted') {sorted_hist_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes")


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
    read), then against its twin: counts exact, t-sums within cnt^2 * 2^-23
    (shared-memory atomics add in a run-dependent order; the twin sums in
    f64). Timed beside B1 (folded) and index_add_ in this call. Returns the
    row and the launch counts of its path."""
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
    err = 0.0
    for name, (cnt, tsum) in outs.items():
        p_cnt, p_tsum = enc.scatter_cnt_tsum_pallas_plain(*cells[name], size)
        torch.cuda.synchronize()
        diff = (tsum - p_tsum).abs()
        if not torch.equal(cnt, p_cnt) or not bool(
                (diff <= p_cnt * p_cnt * 2.0 ** -23).all()):
            raise SystemExit(f"B8 {name}: counts equal "
                             f"{torch.equal(cnt, p_cnt)}, max |dtsum| "
                             f"{diff.max().item()}")
        err = max(err, diff.max().item())
        log(f"B8 {name}: counts exact ({int(p_cnt.sum().item())} events), "
            f"max |dtsum| {diff.max().item():.3e}")
    idx, tv, valid = cells["uniform"]
    ev, nv = ev_sets["uniform"]
    ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas(idx, tv, valid, size))
    b1_ms = time_ms(lambda: enc.scatter_cnt_tsum(ev, nv, height=H, width=W))
    plain_ms = time_ms(lambda: enc.scatter_cnt_tsum_pallas_plain(
        idx, tv, valid, size), n=3, warm=1)
    library_ms = index_add_ms(idx, tv, valid, size)
    bytes_moved = idx.numel() * (4 + 4 + 1) + 2 * idx.shape[0] * size * 4
    bound_ms = bytes_moved / rate * 1e3
    log(f"B8: {ms:.3f} ms; B1 (folded, from events) {b1_ms:.3f} ms and "
        f"index_add_ {library_ms:.3f} ms in this call; twin {plain_ms:.3f} "
        f"ms; bound {bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes"), launches


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
                "scatter_cnt_tsum_pallas_sorted":
                    enc.scatter_cnt_tsum_pallas_sorted,
                "scatter_cnt_tsum_pallas": enc.scatter_cnt_tsum_pallas,
                "taf_update_leaky": enc.taf_update_leaky,
                "taf_update_leaky_raw": enc.taf_update_leaky_raw,
                "taf_update_leaky_v2": enc.taf_update_leaky_v2,
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
        "scatter_cnt_tsum_pallas_sorted": (
            "scatter_cnt_tsum_pallas_sorted", ("gen4_precise",),
            "frlw_evd_tpu_torch/csrc/scatter_sorted.cu",
            "frlw_evd_tpu/encode/pallas_scatter.py:343"),
        "scatter_cnt_tsum_pallas": ("scatter_cnt_tsum_pallas", ("gen1_b8",),
                                    "frlw_evd_tpu_torch/csrc/scatter_dense.cu",
                                    "frlw_evd_tpu/encode/pallas_scatter.py:67"),
        "taf_update_leaky": ("taf_update_leaky", ("gen1",),
                             "frlw_evd_tpu_torch/csrc/taf_update.cu",
                             "frlw_evd_tpu/encode/pallas_update.py:37"),
        "taf_update_leaky_raw": ("taf_update_leaky_raw",
                                 ("gen4", "gen4_bfm_p64_kernel"),
                                 "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                 "frlw_evd_tpu/encode/pallas_update.py:233"),
        "taf_update_leaky_v2": ("taf_update_leaky_v2",
                                ("gen4_sorted", "gen4_precise"),
                                "frlw_evd_tpu_torch/csrc/taf_update.cu",
                                "frlw_evd_tpu/encode/pallas_update.py:143"),
        "bfm_chain_apply_folded": ("bfm_chain_apply_folded",
                                   ("gen4", "gen4_sorted", "gen4_precise"),
                                   "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                                   "frlw_evd_tpu/models/pallas_stem.py:98"),
        "bfm_chain_apply": ("bfm_chain_apply", ("gen4_bfm_p64_kernel",),
                            "frlw_evd_tpu_torch/csrc/bfm_chain.cu",
                            "frlw_evd_tpu/models/pallas_stem.py:59"),
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
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
