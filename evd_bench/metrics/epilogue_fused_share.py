"""epilogue_fused_share: the share of the conv blocks' eval epilogues
(BatchNorm, activation, residual add) that ran as one fused pass, in %:
100 * epilogue_fused / (epilogue_fused + epilogue_plain), the program's
two counters over the traced run's profiled steps (evd_bench/spans.py).
None where the program counts neither."""

from evd_bench import spans


def read(ctx):
    fused = spans.counter(ctx, "epilogue_fused")
    plain = spans.counter(ctx, "epilogue_plain")
    if fused is None or fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
