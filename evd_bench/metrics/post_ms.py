"""post_ms: device ms a step from the start of the program's
`serve.decode` span to the end of its `serve.post` span (decode, then
top-K and the fixpoint NMS, the device's idle time between NMS rounds
included), over the traced run's profiled steps (evd_bench/spans.py).
Nothing runs on the stream between the two spans, so it is the sum of
their event intervals."""

from evd_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "serve.decode", "serve.post")
