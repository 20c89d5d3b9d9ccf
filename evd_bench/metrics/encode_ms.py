"""encode_ms: device ms a step of the encode stage (run_step.stages
["encode_transform"]: histogram, queue update, leaky volume, resize),
CUDA events around the call, mean over the traced run's window."""


def read(ctx):
    ms = ctx.window.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
