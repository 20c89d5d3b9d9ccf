"""Reading a torch.profiler trace of a few steps: the device's busy time
(the union of the intervals in which an operation ran on it), the time of
each kernel by name, and the idle gaps with what the host was doing.

On the card the device's operations are the trace's CUDA activities
(kernels, copies, fills). A CPU run, which only the harness's own tests
make, takes the host's leaf operators in their place.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType

NAME_CHARS = 160


def _device_events(events, cuda: bool):
    if cuda:
        return [e for e in events if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    return [e for e in events if e.device_type == DeviceType.CPU
            and not e.cpu_children and e.name.startswith("aten::")]


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals (the arithmetic of
    the port's utils/profiling.device_busy_us)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _gaps(spans):
    """Idle intervals between the merged busy intervals."""
    out, end = [], None
    for a, b in sorted(spans):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def _host_labels(cpu_events, times):
    """For each time t, the innermost host event running at t: of the
    nested host events that contain t, the one that started last."""
    ev = sorted(cpu_events, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ev]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ev[i].time_range.end < t:
            i -= 1
        out.append(ev[i].name if i >= 0 else "host idle")
    return out


def profile(body) -> dict:
    """Run body() under torch.profiler and read the trace: busy_s,
    window_s (the host's time over the body, device included), kernels
    [(name, start_s, end_s)] in order, and the breakdown's device_ops and
    idle_gaps (at most 10 each, seconds summed by name)."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        body()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    dev = _device_events(events, cuda)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:NAME_CHARS]] += (e.time_range.end
                                         - e.time_range.start) * 1e-6
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.name.startswith("ProfilerStep")]
    gaps = defaultdict(float)
    idle = _gaps(spans)
    for (a, b), label in zip(idle, _host_labels(host, [(a + b) / 2
                                                       for a, b in idle])):
        gaps[label[:NAME_CHARS]] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {
        "busy_s": busy_union(spans) * 1e-6,
        "window_s": window_s,
        "kernels": [(e.name, e.time_range.start * 1e-6,
                     e.time_range.end * 1e-6) for e in sorted(
                         dev, key=lambda e: e.time_range.start)],
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)},
    }


def kernel_seconds(prof: dict, pattern: str) -> float:
    """Device seconds of the traced kernels whose name contains
    `pattern`."""
    return sum(b - a for name, a, b in prof["kernels"] if pattern in name)
