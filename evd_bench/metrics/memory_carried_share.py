"""memory_carried_share: the share of stream-windows whose detector memory
came from the stream's previous window, in %: 100 * memory_carried /
(memory_carried + memory_fresh), the program's two counters over the
traced run's profiled steps (evd_bench/spans.py). The profiled steps come
after the window's, so every stream carries its memory there and a sound
run reads 100; a path that restarts the memory reads less. None where the
program counts neither."""

from evd_bench import spans


def read(ctx):
    carried = spans.counter(ctx, "memory_carried")
    fresh = spans.counter(ctx, "memory_fresh")
    if carried is None or carried + fresh == 0:
        return None
    return 100.0 * carried / (carried + fresh)
