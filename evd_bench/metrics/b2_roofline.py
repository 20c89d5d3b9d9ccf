"""b2_roofline: kernel B2's share of its roofline over the profiled
steps: the least time of its work (evd_bench/roofline/b2.py) over its
device time in the trace."""

from evd_bench import tracing
from evd_bench.roofline import b2, bound_s


def read(ctx):
    t = tracing.kernel_seconds(ctx.profile, b2.TRACE) if ctx.profile else 0
    if t <= 0:
        return None
    H, W = ctx.cfg["sensor_hw"]
    steps = len(ctx.profile["pool_windows"])
    work = b2.work(ctx.window["batch"], H, W, ctx.cfg["K"])
    return 100.0 * steps * bound_s(work) / t
