"""forward_ms: device ms a step of the AED forward, between the CUDA
events of the program's `serve.forward` span, over the traced run's
profiled steps (evd_bench/spans.py)."""

from evd_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "serve.forward")
