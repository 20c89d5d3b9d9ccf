"""Kernel B4 (the BFM stem's channel chain on the folded p64 volume,
csrc/bfm_chain.cu): per pixel the grouped weight-norm 1x1 cascade over
the 2K input channels (embed channels kept a level), the mixer's
`embed * levels` -> 4x -> back 1x1 pair with a silu between, in bf16 on
tensor cores. Reads the bf16 volume, writes the `embed * levels` chain
channels a pixel in bf16; a silu is an exp2 and a reciprocal on the
special function unit."""

import math

TRACE = "bfm_chain_kernel"


def work(streams: int, height: int, width: int, channels: int,
         embed: int = 4) -> dict:
    pix = streams * height * width
    tc, cin, macs, levels = channels // 2, channels, 0, 0
    for _ in range(int(math.log2(tc))):
        out = embed * tc // 2
        macs += out * cin // (tc // 2)          # grouped 1x1, tc/2 groups
        cin, tc, levels = out, tc // 2, levels + 1
    mixer = embed * levels
    macs += 2 * mixer * 4 * mixer               # trans_up, trans_down
    return {"bytes": 2 * pix * channels + 2 * pix * mixer,
            "bf16_flops": 2 * macs * pix,
            "sfu_ops": 2 * 4 * mixer * pix}
