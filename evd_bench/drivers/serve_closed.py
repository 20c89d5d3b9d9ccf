"""Closed-loop serving: every step takes the next pool window for each of
the B streams, runs the system's step on the carried state and reads the
boxes to the host before it submits the next step, as a caller that
waits for its answer does.

Set-up (counted in setup_s): the weights of the configuration's model
family (reference/<family>.py names its parameters) made on the device
from the configuration's seed, the system built from them (the program,
program.py, or what the harness was given in its place), the traffic's
pool drawn on the device and dealt out by the run's seed (generate.py),
the check's recorder, and the cell's warm-up steps, which run every shape
the window runs; the last of them runs the recorder's capture too, where
it has one (`rehearse`), so that the window launches nothing new. The
allocator keeps what the warm-up cached, as a server that has warmed up
does.

A window is due when its step is submitted and done when its boxes are on
the host, so its latency includes the host read and every host sync
inside the step. The measured window runs whole steps until `seconds` have
passed; windows_per_s is B times the steps done over the time they took,
window_p95_ms the 95th percentile of all windows' latencies. The cell's
check provides the recorder that keeps what it compares.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from evd_bench import generate, harness, program, stats, tracing, weights


def _step(system, state, pool, i, events):
    """One step; with `events` (CUDA) the two stages run apart between
    three recorded events."""
    xytp, n_valid = pool.window(i)
    if events is None:
        state, (dets, keep) = system.run_step(state, xytp, n_valid)
    else:
        events[0].record()
        with torch.profiler.record_function("evd_bench.encode"):
            state, vol = system.stages["encode_transform"](state, xytp,
                                                           n_valid)
        events[1].record()
        with torch.profiler.record_function("evd_bench.detect"):
            dets, keep = system.stages["detect"](vol)
        events[2].record()
        del vol
    with torch.profiler.record_function("evd_bench.host_read"):
        dets, keep = dets.cpu(), keep.cpu()
    return state, dets, keep


def setup(ctx, checker):
    """(system, pool, batch, recorder) of ctx's cell, warmed up."""
    cfg, cell, device = ctx.cfg, ctx.cell, ctx.device
    B = cell["batch"]
    marks = [("start", ctx.t0), ("imports", time.perf_counter())]
    family = ctx.bench.code("reference", cfg["model"]["family"])
    params = weights.make_params(family.param_spec(cfg["model"]),
                                 cfg["weights_seed"], device)
    system = (ctx.build or program.build)(cfg, params, B, device)
    del params
    marks.append(("model", time.perf_counter()))
    pool = generate.make_pool(ctx.bench, ctx.traffic, B,
                              cfg["events_per_window"], cfg["sensor_hw"],
                              ctx.seed, device)
    marks.append(("traffic", time.perf_counter()))
    rec = checker.recorder(ctx, system, B)
    state = system.new_state()
    n = cell["warmup_steps"]
    for i in range(n):
        # the first capture of the window stalled its step by 0.11-0.23 s
        # (what it launches was loaded then), so the warm-up runs it once
        rehearse = i == n - 1 and hasattr(rec, "rehearse")
        if rehearse:
            rec.rehearse(i)
        state, dets, keep = _step(system, state, pool, i, None)
        if rehearse:
            rec.end(i, dets, keep)
    del state, dets, keep
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    print("evd_bench: set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks,
                                                            marks[1:])),
          file=sys.stderr)
    return system, pool, B, rec


def run(ctx, checker) -> dict:
    """Set up ctx's cell, drive it for ctx.seconds from a fresh state and
    return the window: its end-to-end values, what the check needs (the
    pool, the final state, the recorder, the launches), and with
    ctx.trace the profile of the cell's `profile_steps` more steps. Steps
    the recorder still needs after the window run untimed."""
    system, pool, B, rec = setup(ctx, checker)
    cuda = ctx.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    kernels = ctx.cell["kernels"]
    state = system.new_state()
    timed = ctx.trace and cuda
    marks = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches0 = program.launch_counts(kernels)
    latencies = []
    step = 0
    t_start = time.perf_counter()
    while True:
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  if timed else None)
        rec.begin(step)
        t_due = time.perf_counter()
        state, dets, keep = _step(system, state, pool, step, events)
        t_done = time.perf_counter()
        rec.end(step, dets, keep)
        latencies.append(t_done - t_due)
        if events is not None:
            marks.append(events)
        step += 1
        if t_done - t_start >= ctx.seconds:
            break
    elapsed = t_done - t_start
    launches = {k: v - launches0[k]
                for k, v in program.launch_counts(kernels).items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_steps = step
    while not rec.done():
        rec.begin(step)
        state, dets, keep = _step(system, state, pool, step, None)
        rec.end(step, dets, keep)
        step += 1
    out = {
        "t_start": t_start,
        "steps": window_steps,
        "attempted": B * window_steps,
        "failed": 0,
        "elapsed_s": elapsed,
        "latencies_s": latencies,
        "end_to_end": {
            "windows_per_s": B * window_steps / elapsed,
            "window_p95_ms": 1e3 * stats.percentile(latencies, 95)},
        "launches": launches,
        "peak_bytes": peak,
        "memory_peak_bytes": max(setup_peak, peak),
        "batch": B,
        "pool": pool,
        "recorder": rec,
    }
    if marks:
        torch.cuda.synchronize()
        out["encode_ms"] = [a.elapsed_time(b) for a, b, _ in marks]
        out["detect_ms"] = [b.elapsed_time(c) for _, b, c in marks]
    if ctx.trace:
        first = step

        def body():
            nonlocal state, step
            for _ in range(ctx.cell["profile_steps"]):
                state, _, _ = _step(system, state, pool, step, (
                    [torch.cuda.Event() for _ in range(3)] if cuda
                    else None))
                step += 1
        out["profile"] = tracing.profile(body)
        out["profile"]["pool_windows"] = [
            i % pool.xytp.shape[0] for i in range(first, step)]
    rec.close()
    out["state"] = state
    out["steps_run"] = step
    del system
    harness.free(ctx.device)
    return out
