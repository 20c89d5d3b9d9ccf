"""Bursty, clustered windows. A stream's count in a window is
E * clip(lognormal(mu, sigma), lo, hi), at least `min_events`; a share
`background` of the events is uniform over the sensor and the rest falls
around `hotspots` Gaussian hotspots a stream, each with its own size and
a velocity, moving from one window of the pool to the next; t is sorted
within the window. (The rule of the port's synth_events_skewed, drawn on
the device.)"""

from __future__ import annotations

import torch


def draw(gen, n, batch, E, h, w, device, p, first_step, period):
    shape = (n, batch, E)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)
    burst = torch.exp(torch.randn(n, batch, generator=gen, device=device)
                      * p["sigma"] + p["mu"]).clamp(p["lo"], p["hi"])
    n_valid = torch.clamp_min((E * burst).to(torch.int32), p["min_events"])
    k = p["hotspots"]
    cx0, cy0 = rand(batch, k) * w, rand(batch, k) * h
    vx = (rand(batch, k) * 2 - 1) * p["speed_x"]
    vy = (rand(batch, k) * 2 - 1) * p["speed_y"]
    sig = p["size_min"] + rand(batch, k) * (max(h, w) * p["size_max_frac"]
                                            - p["size_min"])
    # window j of the kinds' cycle sits at pool step first_step + j * period
    steps = (first_step + period * torch.arange(n, device=device)).float()
    dt = steps[:, None, None] * p["window_s"]
    cx = (cx0[None] + vx[None] * dt).clamp(0, w - 1)
    cy = (cy0[None] + vy[None] * dt).clamp(0, h - 1)
    spot = torch.randint(0, k, shape, generator=gen, device=device)
    pick = lambda t: torch.gather(t.expand(n, batch, k), 2, spot)
    x = pick(cx) + torch.randn(shape, generator=gen, device=device) * pick(
        sig[None])
    y = pick(cy) + torch.randn(shape, generator=gen, device=device) * pick(
        sig[None])
    bg = rand(*shape) < p["background"]
    x = torch.where(bg, rand(*shape) * w, x).clamp(0, w - 1).floor()
    y = torch.where(bg, rand(*shape) * h, y).clamp(0, h - 1).floor()
    t = torch.sort(rand(*shape), dim=2).values
    pol = torch.randint(0, 2, shape, generator=gen, device=device).float()
    return torch.stack([x, y, t, pol], -1), n_valid
