"""Kernel B1 (the event histogram, csrc/scatter_hist.cu): per stream the
count and t-sum of each (pixel, polarity) cell over the window's events.
Reads each valid event's x, y, t, p (f32) and the stream's n_valid; writes
the count and t-sum planes (f32) and the stream's any-event flag."""

TRACE = "tile_kernel"


def work(events: int, streams: int, height: int, width: int) -> dict:
    cells = streams * height * width * 2
    return {"bytes": 16 * events + 4 * streams + 8 * cells + 4 * streams}
