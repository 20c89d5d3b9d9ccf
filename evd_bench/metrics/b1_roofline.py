"""b1_roofline: kernel B1's share of its roofline over the profiled
steps: the least time of its work for the events actually drawn
(evd_bench/roofline/b1.py) over its device time in the trace."""

from evd_bench import tracing
from evd_bench.roofline import b1, bound_s


def read(ctx):
    t = tracing.kernel_seconds(ctx.profile, b1.TRACE) if ctx.profile else 0
    if t <= 0:
        return None
    H, W = ctx.cfg["sensor_hw"]
    pool, B = ctx.window["pool"], ctx.window["batch"]
    E = pool.xytp.shape[2]
    bound = sum(bound_s(b1.work(int(pool.n_valid[w].clamp_max(E).sum()),
                                B, H, W))
                for w in ctx.profile["pool_windows"])
    return 100.0 * bound / t
