"""Kernel B2 (the TAF queue update and leaky transform on the folded
queue, csrc/taf_update.cu): reads the f32 queue (2K slots a pixel), the
count and t-sum planes and the any-event flags; writes the queue back and
the bf16 volume (2K channels a pixel)."""

TRACE = "taf_update_leaky_kernel"


def work(streams: int, height: int, width: int, K: int) -> dict:
    pix = streams * height * width
    return {"bytes": 2 * 4 * pix * 2 * K + 2 * 4 * pix * 2 + 4 * streams
            + 2 * pix * 2 * K}
