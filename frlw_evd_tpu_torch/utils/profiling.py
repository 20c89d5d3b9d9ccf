"""FLOP count of a call (counterpart of
frlw_evd_tpu/utils/profiling.py::flops_report, which reads XLA's cost
analysis of the compiled function), and the device's busy time in a
torch.profiler trace.

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

from typing import Any, Callable

from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode


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
