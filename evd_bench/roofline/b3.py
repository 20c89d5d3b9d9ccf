"""Kernel B3 (the TAF queue update and leaky transform on the patchified
1 Mpx queue, csrc/taf_update.cu): the same work as B2 over the sensor's
pixels, the queue and the volume in the p64 layout."""

from evd_bench.roofline import b2

TRACE = "taf_update_leaky_kernel"


def work(streams: int, height: int, width: int, K: int) -> dict:
    return b2.work(streams, height, width, K)
