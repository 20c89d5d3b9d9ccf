"""The work of each hand-written kernel, counted from its inputs' shapes
and never from the implementation, and the least time the chip could do
it in: the largest of the bytes over the HBM bandwidth (each input byte
read once, each output byte written once) and each type of operation over
its peak."""

from __future__ import annotations

from evd_bench import peaks


def bound_s(work: dict) -> float:
    return max(work.get("bytes", 0) / peaks.HBM_BYTES_PER_S,
               work.get("bf16_flops", 0) / peaks.BF16_FLOPS,
               work.get("f32_flops", 0) / peaks.F32_FLOPS,
               work.get("sfu_ops", 0) / peaks.SFU_OPS_PER_S)
