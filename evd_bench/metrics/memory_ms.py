"""memory_ms: device ms a step of the recurrent detector's memory (RED's
five ConvLSTMs), between the CUDA events of the program's `serve.memory`
span, over the traced run's profiled steps (evd_bench/spans.py). None
where the program has no such span."""

from evd_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "serve.memory")
