"""host_syncs: the program's host reads of a computed value a step (its
`host_syncs` counter), over the traced run's profiled steps; the
benchmark's own read of the boxes is not counted (evd_bench/spans.py)."""

from evd_bench import spans


def read(ctx):
    return spans.counter(ctx, "host_syncs")
