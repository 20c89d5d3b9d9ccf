"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
# the special function unit: 16 lanes an SM against 128 f32 lanes, so an
# exp2 or a reciprocal issues at the f32 rate over 16 (a silu takes both)
SFU_OPS_PER_S = F32_FLOPS / 16
