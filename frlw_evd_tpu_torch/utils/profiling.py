"""Profiling helpers (counterpart of frlw_evd_tpu/utils/profiling.py):
`Timer`, wall-clock spans fenced on the device of a result; `trace`, a
torch.profiler trace written for Chrome or TensorBoard; `flops_report`,
the FLOP count of a call (JAX reads XLA's cost analysis of the compiled
function); and the device's busy time in a torch.profiler trace.

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
import time
from typing import Any, Callable, Dict

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
