"""Uniform windows: every slot an event, x and y uniform over the sensor,
t uniform in [0, 1), p uniform in {0, 1}: the most work a window of E
slots can give the encode."""

from __future__ import annotations

import torch


def draw(gen, n, batch, E, h, w, device, p, first_step, period):
    shape = (n, batch, E)
    ev = torch.empty(*shape, 4, device=device)
    ev[..., 0] = torch.randint(0, w, shape, generator=gen, device=device)
    ev[..., 1] = torch.randint(0, h, shape, generator=gen, device=device)
    ev[..., 2] = torch.rand(shape, generator=gen, device=device)
    ev[..., 3] = torch.randint(0, 2, shape, generator=gen, device=device)
    return ev, torch.full((n, batch), E, dtype=torch.int32, device=device)
