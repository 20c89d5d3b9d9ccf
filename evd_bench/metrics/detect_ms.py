"""detect_ms: device ms a step of the detect stage (run_step.stages
["detect"]: the AED forward, decode, top-K and NMS with its host syncs),
CUDA events around the call, mean over the traced run's window."""


def read(ctx):
    ms = ctx.window.get("detect_ms")
    return sum(ms) / len(ms) if ms else None
