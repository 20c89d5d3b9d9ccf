"""Profiling helpers (counterpart of frlw_evd_tpu/utils/profiling.py):
`Timer`, wall-clock spans fenced on the device of a result; `trace`, a
torch.profiler trace written for Chrome or TensorBoard; `flops_report`,
the FLOP count of a call (JAX reads XLA's cost analysis of the compiled
function); the device's busy time in a torch.profiler trace; and the
program's own spans and counters (`span`, `count`, `spans_summary`).

Spans and counters. `span(name)` marks a part of the program and
`count(name, n)` adds to a counter of the innermost open span. They record
only while a torch profiler is recording or inside a `recording()` block;
otherwise a site costs one flag check and enters a shared null context
(`record_function` alone costs 9-13 µs an enter and exit on an H100 host,
profiled or not). A recorded span opens a named range in the profiler's
trace (record_function's C++ form, `_RecordFunctionFast`), so the trace
names the host time inside it; on a process that has initialised CUDA it
records a CUDA event at enter and one at exit on the stream current at its
enter, unless opened with events=False; and it keeps a record (name,
parent record, step number, host `perf_counter_ns` start and end, the two
events, its counts) in a ring of the last `SPAN_RING` records. A span
opened with `new_step=True` starts a new step number; the spans that
follow, up to the next such span, share it. `spans_summary` reads the ring
(one device synchronize) and `clear_spans` empties it. Spans are off under
torch.export, which records no profile; the sites branch on Python values
only.

`flops_report` runs the call once under torch.utils.flop_counter's
FlopCounterMode. That counts the matrix products and convolutions, forward
and backward (aten mm, addmm, bmm, baddbmm, convolution and
convolution_backward, at 2 FLOPs a multiply-add, grouped convolutions at
their real size), and nothing elementwise: no BatchNorm, activation,
dropout, loss, assignment or optimiser update. Those are memory-bound and
far below the products' count, so MFU over the dense bf16 tensor-core peak
is taken over the counted FLOPs.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode


class Timer:
    """Wall-clock spans with device fencing (profiling.py:19-71).

    >>> t = Timer()
    >>> with t.span("step"):
    ...     out = t.fence(step(x))  # out's stream synchronized on exit

    A span synchronizes on exit only the current stream of the device of
    the tensor it was given through `fence` (nothing for a CPU tensor),
    never a device the caller did not fence.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._last_result = None

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        try:
            yield self
        finally:
            if self._last_result is not None:
                _synchronize(self._last_result)
                self._last_result = None
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def fence(self, result):
        """Mark a result (a tensor, or a tuple / list / dict of them) whose
        device the span waits for on exit; returns it."""
        self._last_result = result
        return result

    def avg_ms(self, name: str) -> float:
        return 1000.0 * self.totals.get(name, 0.0) / max(
            self.counts.get(name, 1), 1)

    def report(self) -> str:
        return ", ".join(f"{k}: {self.avg_ms(k):.2f} ms"
                         for k in sorted(self.totals))


def _synchronize(result) -> None:
    """Wait for the current stream of each CUDA device that holds a tensor
    of `result`."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.current_stream(result.device).synchronize()
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace"):
    """torch.profiler over the block (CPU and, where there is a card, CUDA
    activities), its Chrome trace written to <log_dir>/trace.json on exit
    (profiling.py:74-80, where jax.profiler writes the trace). Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SPAN_RING = 4096

_profiler_enabled = torch._C._autograd._profiler_enabled
# record_function's C++ form: the same named range in the profiler's trace
# for 0.3-1.6 µs an enter and exit on an H100 host
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_recording = 0  # open recording() blocks
_step = 0  # the step number of the spans being recorded
_ring: deque = deque(maxlen=SPAN_RING)


class _OpenSpans(threading.local):
    """The recording spans open in this thread, innermost last."""

    def __init__(self):
        self.stack = []


_open = _OpenSpans()


# the one context of every span site that does not record (a nullcontext,
# which torch.export's strict tracing enters where it refuses other classes)
_NULL = contextlib.nullcontext()


class SpanRecord:
    """One recorded span: `name`, `parent` (the SpanRecord open around it,
    or None), `step`, host `start_ns` / `end_ns` (perf_counter_ns; end_ns
    None while open), the CUDA events `ev_start` / `ev_end` (None where
    CUDA is not initialised) and `counts`, the counters bumped while it
    was the innermost open span."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns", "ev_start",
                 "ev_end", "counts", "_new_step", "_events", "_rf", "_stream")

    def __init__(self, name: str, new_step: bool, events: bool):
        self.name, self._new_step, self._events = name, new_step, events
        self.end_ns = self.ev_start = self.ev_end = None

    def __enter__(self):
        global _step
        stack = _open.stack
        self.parent = stack[-1] if stack else None
        if self._new_step:
            _step += 1
        self.step = _step
        self.counts = {}
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        if self._events and torch.cuda.is_initialized():
            self._stream = torch.cuda.current_stream()
            self.ev_start = torch.cuda.Event(enable_timing=True)
            self.ev_start.record(self._stream)
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        _ring.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.ev_start is not None:
            self.ev_end = torch.cuda.Event(enable_timing=True)
            self.ev_end.record(self._stream)
            self._stream = None
        _open.stack.pop()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return None


def span(name: str, *, new_step: bool = False, events: bool = True):
    """Context of the program part `name`: a SpanRecord while a torch
    profiler records or a `recording()` block is open, else a shared
    context that does nothing. `new_step` starts a new step number.
    events=False records no CUDA events (no device time): for spans inside
    a loop that syncs the host every pass, where two events cost 13-29 µs
    of host time a pass on an H100 host."""
    if _recording or _profiler_enabled():
        return SpanRecord(name, new_step, events)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost recording span (nothing
    where none is open)."""
    stack = _open.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans inside the block without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def span_records(since_ns: Optional[int] = None) -> list:
    """The closed SpanRecords in the ring, oldest first; with `since_ns`,
    those that started at or after that perf_counter_ns."""
    return [r for r in list(_ring) if r.end_ns is not None
            and (since_ns is None or r.start_ns >= since_ns)]


def spans_summary(since_ns: Optional[int] = None) -> dict:
    """The ring's closed spans (`span_records(since_ns)`), summed:
    {"steps": the number of distinct step numbers, "spans": {name:
    {"calls", "host_ms", "device_ms"}}, "counts": {counter: total}}.
    device_ms is the sum of elapsed_time between each span's two events,
    None for a name without events; reading them synchronizes the device
    once."""
    records = span_records(since_ns)
    if any(r.ev_start is not None for r in records):
        torch.cuda.synchronize()
    spans: Dict[str, dict] = {}
    counts: Dict[str, int] = {}
    for r in records:
        s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                      "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += (r.end_ns - r.start_ns) * 1e-6
        if r.ev_start is not None:
            s["device_ms"] = ((s["device_ms"] or 0.0)
                              + r.ev_start.elapsed_time(r.ev_end))
        for k, v in r.counts.items():
            counts[k] = counts.get(k, 0) + v
    return {"steps": len({r.step for r in records}), "spans": spans,
            "counts": counts}


def clear_spans() -> None:
    """Empty the ring."""
    _ring.clear()


def flops_report(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run fn(*args, **kwargs) once and return {"flops": the counted FLOPs,
    "result": what fn returned}."""
    with FlopCounterMode(display=False) as counter:
        result = fn(*args, **kwargs)
    return {"flops": counter.get_total_flops(), "result": result}


def device_busy_us(events) -> float:
    """Microseconds in which at least one kernel ran on the device: the
    union of the intervals of a torch.profiler trace's device events
    (`prof.events()`; user annotations are not kernels)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy
