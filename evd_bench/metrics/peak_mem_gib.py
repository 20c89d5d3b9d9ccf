"""peak_mem_gib: torch.cuda.max_memory_allocated() over the measured
window (reset at its start), in GiB."""


def read(ctx):
    peak = ctx.window.get("peak_bytes", 0)
    return peak / 2 ** 30 if peak else None
