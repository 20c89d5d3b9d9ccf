"""mfu.serve: the whole step's share of the chip's dense bf16 peak: the
model's FLOPs a window, counted on the reference of its family
(roofline/<family>.py), times the traced run's windows per second."""

from evd_bench import peaks


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    family = ctx.cfg["model"]["family"]
    flops = ctx.bench.code("roofline", family).flops_per_window(ctx.cfg)
    rate = ctx.window["end_to_end"]["windows_per_s"]
    return 100.0 * flops * rate / peaks.BF16_FLOPS
