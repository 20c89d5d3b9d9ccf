"""Seeded weights for the AED, made on the device in a few large draws.

Serving loads trained weights; random ones need a spread to behave like
them (the rule of the port's smoke runs): convolutions lecun-normal,
weight-norm directions N(0, 0.01) with unit gain, BatchNorm scales U(1, 2)
and shifts N(0, 0.5) over identity running statistics, so the head
outputs are not nearly constant, and the objectness biases at 2.0 so that
scores pass the confidence threshold and NMS has real work. The class
biases take the YOLOX prior -log(99).

The weights stand for a deployment's trained checkpoint, so they are the
configuration's ("weights_seed" in its file), the same in every run; the
run's seed draws the traffic. Weights drawn from the run's seed changed
the work: the NMS rounds a step and the boxes kept, and with them the
step time by 2-4% from seed to seed.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use (`stream`) of a run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) % 2 ** 59) * 16 + stream)


def make_params(spec, seed: int, device) -> dict:
    """The parameter dict of `spec` ([(name, shape, kind)],
    reference.aed.param_spec) in f32 on `device`, drawn from `seed`."""
    gen = generator(seed, 1, device)
    numel = [math.prod(shape) for _, shape, _ in spec]
    normal = [n if kind in ("conv", "wn_v", "bn_b") else 0
              for n, (_, _, kind) in zip(numel, spec)]
    uniform = [n if kind == "bn_w" else 0 for n, (_, _, kind) in zip(numel,
                                                                       spec)]
    z = torch.randn(sum(normal), generator=gen, device=device).split(normal)
    u = torch.rand(sum(uniform), generator=gen, device=device).split(uniform)
    fill = {"wn_g": 1.0, "zero": 0.0, "cls_bias": -math.log(99.0),
            "obj_bias": 2.0, "bn_mean": 0.0, "bn_var": 1.0}
    out = {}
    for (name, shape, kind), zi, ui in zip(spec, z, u):
        if kind == "conv":
            t = zi * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "wn_v":
            t = zi * 0.01
        elif kind == "bn_b":
            t = zi * 0.5
        elif kind == "bn_w":
            t = 1.0 + ui
        elif kind == "bn_count":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:
            t = torch.full(shape, fill[kind], device=device)
        out[name] = t.reshape(shape)
    return out
