"""The program's own spans and counters, read after a traced run.

The port records spans and counters inside its serving step while a torch
profiler records (frlw_evd_tpu_torch/utils/profiling.py: `span`, `count`,
`spans_summary`), so a traced run's profiled steps leave them in the
program's ring. This module, beside program.py the only one of the
harness that imports the program, sums the records that started after
the measured window opened, once a run, and the per-layer readers under
metrics/ divide them by the steps counted:

  serve.encode, serve.detect      the two stages (host ms: host_enqueue_ms)
  serve.forward                   the AED forward (device ms: forward_ms)
  serve.decode, serve.post        decode; top-K and NMS (device ms: post_ms)
  host_sync                       a host read inside a step (host ms:
                                  sync_wait_ms)
  nms_rounds, host_syncs          counters (nms_rounds, host_syncs)

Where the program keeps no such ring (a program without it), or nothing
recorded in the run (the control or a toy system built in the program's
place), the summary is {} and every reader returns None.
"""

from __future__ import annotations


def summary(ctx) -> dict:
    """{"steps", "spans", "counts"} of ctx's run (profiling.spans_summary
    over the records since the window's start), or {}; read once a run."""
    if not hasattr(ctx, "spans"):
        ctx.spans = _read(ctx)
    return ctx.spans


def _read(ctx) -> dict:
    from frlw_evd_tpu_torch.utils import profiling
    read = getattr(profiling, "spans_summary", None)
    if read is None:
        return {}
    got = read(since_ns=int(ctx.window["t_start"] * 1e9))
    return got if got.get("steps") else {}


def counter(ctx, name: str):
    """Counter `name` a step (0.0 where no span bumped it), or None."""
    s = summary(ctx)
    if not s:
        return None
    return float(s["counts"].get(name, 0)) / s["steps"]


def host_ms(ctx, *names: str):
    """Host ms a step inside the spans `names` (0.0 for one that did not
    run), or None."""
    s = summary(ctx)
    if not s:
        return None
    return float(sum(s["spans"][n]["host_ms"] for n in names
                     if n in s["spans"])) / s["steps"]


def device_ms(ctx, *names: str):
    """Device ms a step between the CUDA events of the spans `names`,
    summed; None where any of them ran without events (the CPU) or not at
    all."""
    s = summary(ctx)
    if not s:
        return None
    got = [s["spans"].get(n, {}).get("device_ms") for n in names]
    if any(v is None for v in got):
        return None
    return float(sum(got)) / s["steps"]
