"""The traffic generator: a pool of distinct 10 ms event windows for B
streams, drawn on the device from the run's seed, read from a traffic
file (`traffic/<name>.json`).

A traffic file names the kinds of window in the pool, in the order they
alternate, with their parameters. Each kind is a file of its own,
`generators/<kind>.py`, whose `draw(gen, n, batch, E, h, w, device, p,
first_step, period)` returns n windows ((n, batch, E, 4) f32 events and
(n, batch) int32 counts) from the parameters p, window j of them at pool
step first_step + j * period; a new kind is a new file.

Coordinates are whole pixels. Every window has at least one event a
stream. The pool is (P, B, E, 4) f32 [x, y, t, p] with n_valid (P, B)
int32; step i of a run reads pool window i % P.

The windows themselves are drawn from the mix's own `content_seed`, so
every run serves the same set of windows, events and counts; the run's
seed deals them out in another order: which stream plays which drawn
stream's sequence, and from which window of the pool it starts (whole
cycles of the kinds, so that the kinds still alternate step by step).
Windows drawn from the run's seed changed the work from seed to seed
(the NMS rounds a step, with the boxes the windows raise): two runs of
one seed read 0.01% apart in step time at 1 Mpx, three seeds 1.3%.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .weights import generator


class Pool(NamedTuple):
    xytp: torch.Tensor      # (P, B, E, 4) f32
    n_valid: torch.Tensor   # (P, B) int32

    def window(self, step: int):
        i = step % self.xytp.shape[0]
        return self.xytp[i], self.n_valid[i]


def make_pool(bench, traffic: dict, batch: int, events: int, sensor_hw,
              seed: int, device) -> Pool:
    """The pool of `traffic` ({"pool": P, "kinds": [{"kind": ..., ...}]})
    for `batch` streams of `events` slots a window on a sensor_hw sensor;
    the kinds alternate window by window, each found under `bench`'s
    generators/."""
    P, kinds = traffic["pool"], traffic["kinds"]
    h, w = sensor_hw
    gen = generator(traffic["content_seed"], 2, device)
    xytp = torch.empty(P, batch, events, 4, device=device)
    n_valid = torch.empty(P, batch, dtype=torch.int32, device=device)
    for j, spec in enumerate(kinds):
        n = len(range(j, P, len(kinds)))
        draw = bench.code("generators", spec["kind"]).draw
        ev, nv = draw(gen, n, batch, events, h, w, device, p=spec,
                      first_step=j, period=len(kinds))
        xytp[j::len(kinds)] = ev
        n_valid[j::len(kinds)] = nv
        del ev, nv
    deal = generator(seed, 2, device)
    stream = torch.randperm(batch, generator=deal, device=device)
    start = torch.randint(0, max(P // len(kinds), 1), (batch,),
                          generator=deal, device=device) * len(kinds)
    rows = (torch.arange(P, device=device)[:, None] + start) % P
    return Pool(xytp[rows, stream], n_valid[rows, stream])
