"""idle_share: the share of the profiled steps' time in which no
operation ran on the device: 1 - busy / window, busy the union of the
trace's device intervals."""


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
