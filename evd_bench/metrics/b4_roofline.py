"""b4_roofline: kernel B4's share of its roofline over the profiled
steps: the least time of its work (evd_bench/roofline/b4.py; the silu on
the special function unit bounds it) over its device time in the
trace."""

from evd_bench import tracing
from evd_bench.roofline import b4, bound_s


def read(ctx):
    t = tracing.kernel_seconds(ctx.profile, b4.TRACE) if ctx.profile else 0
    if t <= 0:
        return None
    H, W = ctx.cfg["sensor_hw"]
    steps = len(ctx.profile["pool_windows"])
    return 100.0 * steps * bound_s(b4.work(
        ctx.window["batch"], H, W, ctx.cfg["model"]["input_channels"])) / t
