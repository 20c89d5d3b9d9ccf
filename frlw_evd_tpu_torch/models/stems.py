"""TAF input stems (counterpart of frlw_evd_tpu/models/stems.py).

`BinsFusionModule` is the BFM stem of the AED serving path: a cascade of
grouped weight-normalised 1x1 convs that halves the number of time bins at
each level and keeps the first `embed_dim` channels of each, an MLP channel
mixer with a residual, then the fused patchify + 3x3 conv. The input
channels are (bin, polarity) interleaved, c = 2*bin + p.
"""

from __future__ import annotations

from math import log2

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, get_activation


class WeightNormConv1x1(nn.Module):
    """Grouped 1x1 conv with weight normalisation (stems.py:25-57):
    w = g * v / sqrt(sum(v^2) + 1e-12), the sum over every dim except the
    output one. Parameters carry torch's weight_norm names and layout
    (`weight_v` (O, I/groups, 1, 1), `weight_g` (O,)), but the norm is
    computed here with the JAX package's 1e-12 guard."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight_v = nn.Parameter(torch.empty(out_channels,
                                                 in_channels // groups, 1, 1))
        self.weight_g = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        v = self.weight_v
        norm = torch.sqrt((v * v).sum(dim=(1, 2, 3)) + 1e-12)
        w = v * (self.weight_g / norm).view(-1, 1, 1, 1)
        return F.conv2d(x, w, self.bias, groups=self.groups)


class BinsFusionModule(nn.Module):
    """BFM stem (stems.py:90-134). in_channels must be 2K. Dropout is a
    no-op at eval and is not modelled."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 4):
        super().__init__()
        if ksize != 3:
            raise ValueError("the port's BFM stem is the fused ksize=3 form")
        tc = in_channels // 2
        self.levels = int(log2(tc))
        self.embed_dim = embed_dim
        cin = in_channels
        for i in range(self.levels):
            out_ch = embed_dim * tc // 2
            self.add_module(f"convs_{i}",
                            WeightNormConv1x1(cin, out_ch, groups=tc // 2))
            cin = out_ch
            tc //= 2
        mixer = embed_dim * self.levels
        self.trans_up = nn.Conv2d(mixer, mixer * 4, 1)
        self.trans_down = nn.Conv2d(mixer * 4, mixer, 1)
        self.act = get_activation(act)
        self.conv = BaseConv(mixer, out_channels, 3, act=act,
                             patchify_fused=True)

    def forward(self, x):
        xout = []
        h = x
        for i in range(self.levels):
            h = F.relu(getattr(self, f"convs_{i}")(h))
            xout.append(h[:, :self.embed_dim])
        h = torch.cat(xout, dim=1)
        h = h + self.trans_down(self.act(self.trans_up(h)))
        return self.conv(h)
