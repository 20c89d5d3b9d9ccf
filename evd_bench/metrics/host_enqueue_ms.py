"""host_enqueue_ms: host ms a step inside the program's `serve.encode`
and `serve.detect` spans less the time inside its `host_sync` spans: the
host's own cost of issuing a step, over the traced run's profiled steps.
Read under the profiler, so it includes the profiler's cost an operation
(evd_bench/spans.py)."""

from evd_bench import spans


def read(ctx):
    s = spans.summary(ctx)
    if not s or not {"serve.encode", "serve.detect"} <= s["spans"].keys():
        return None
    return (spans.host_ms(ctx, "serve.encode", "serve.detect")
            - spans.host_ms(ctx, "host_sync"))
