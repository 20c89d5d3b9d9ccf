"""sync_wait_ms: host ms a step inside the program's `host_sync` spans,
the host waiting on the card, over the traced run's profiled steps
(evd_bench/spans.py)."""

from evd_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "host_sync")
