"""nms_rounds: fixpoint NMS rounds a step, the program's `nms_rounds`
counter over the traced run's profiled steps (evd_bench/spans.py)."""

from evd_bench import spans


def read(ctx):
    return spans.counter(ctx, "nms_rounds")
