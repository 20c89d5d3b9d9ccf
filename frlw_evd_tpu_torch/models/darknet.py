"""Darknet backbones (counterpart of frlw_evd_tpu/models/darknet.py).

`Darknet` (depth 21) is the AED backbone: pluggable stem, four ResLayer
groups and the SPP block in dark5. `CSPDarknet` is the standard YOLOX
backbone of the yolox family. Both return the (dark3, dark4, dark5)
pyramid, NCHW."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import BaseConv, CSPLayer, DWConv, ResLayer, SPPBottleneck

BLOCKS = (1, 2, 2, 1)     # ResLayers per group at depth 21 (darknet.py:18)


class _GroupLayer(nn.Module):
    """Stride-2 conv followed by num_blocks ResLayers (darknet.py:21-35)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int,
                 act: str = "silu"):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv = BaseConv(in_channels, out_channels, 3, 2, act=act)
        for i in range(num_blocks):
            self.add_module(f"res_{i}", ResLayer(out_channels, act=act))

    def forward(self, x):
        x = self.conv(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i}")(x)
        return x


class _SPPBlock(nn.Module):
    """conv1x1 → conv3x3 → SPP → conv3x3 → conv1x1 (darknet.py:38-52)."""

    def __init__(self, in_channels: int, filters: Sequence[int],
                 act: str = "silu"):
        super().__init__()
        f0, f1 = filters
        self.conv1 = BaseConv(in_channels, f0, 1, act=act)
        self.conv2 = BaseConv(f0, f1, 3, act=act)
        self.spp = SPPBottleneck(f1, f0, act=act)
        self.conv3 = BaseConv(f0, f1, 3, act=act)
        self.conv4 = BaseConv(f1, f0, 1, act=act)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        return self.conv4(self.conv3(self.spp(x)))


class Darknet(nn.Module):
    """Darknet-21 with uniform AED channels (darknet.py:55-89).

    stem: a module class taking (in_channels, out_channels, ksize, act)."""

    def __init__(self, stem, in_channels: int, stem_out_channels: int = 64,
                 out_channels: Sequence[int] = (256, 256, 256),
                 act: str = "silu"):
        super().__init__()
        base = stem_out_channels
        c3, c4, c5 = out_channels
        self.stem = stem(in_channels, base, ksize=3, act=act)
        self.dark2 = _GroupLayer(base, base * 2, BLOCKS[0], act=act)
        self.dark3 = _GroupLayer(base * 2, c3, BLOCKS[1], act=act)
        self.dark4 = _GroupLayer(c3, c4, BLOCKS[2], act=act)
        self.dark5_group = _GroupLayer(c4, c5, BLOCKS[3], act=act)
        self.dark5_spp = _SPPBlock(c5, (c5, c5), act=act)

    def forward(self, x):
        x = self.dark2(self.stem(x))
        d3 = self.dark3(x)
        d4 = self.dark4(d3)
        d5 = self.dark5_spp(self.dark5_group(d4))
        return [d3, d4, d5]


class CSPDarknet(nn.Module):
    """Standard YOLOX CSPDarknet (darknet.py:92-129): the yolox exp uses
    dep_mul 0.33 and wid_mul 0.5, so channels 32 (stem), 64, 128, 256, 512
    and CSP depths 1, 3, 3, 1. stem: a module class taking (in_channels,
    out_channels, ksize, act); in_channels is its input's channels.
    Submodules carry flax's names (dark2_conv, dark2_csp, ..., dark5_spp,
    dark5_csp)."""

    def __init__(self, stem, in_channels: int, dep_mul: float = 0.33,
                 wid_mul: float = 0.5, depthwise: bool = False,
                 act: str = "silu"):
        super().__init__()
        conv = DWConv if depthwise else BaseConv
        base = int(wid_mul * 64)
        depth = max(round(dep_mul * 3), 1)
        self.stem = stem(in_channels, base, ksize=3, act=act)
        cin = base
        for name, mul, n in (("dark2", 2, depth), ("dark3", 4, depth * 3),
                             ("dark4", 8, depth * 3)):
            self.add_module(f"{name}_conv", conv(cin, base * mul, 3, 2,
                                                 act=act))
            self.add_module(f"{name}_csp", CSPLayer(
                base * mul, base * mul, n=n, depthwise=depthwise, act=act))
            cin = base * mul
        self.dark5_conv = conv(cin, base * 16, 3, 2, act=act)
        self.dark5_spp = SPPBottleneck(base * 16, base * 16, act=act)
        self.dark5_csp = CSPLayer(base * 16, base * 16, n=depth,
                                  shortcut=False, depthwise=depthwise,
                                  act=act)

    def forward(self, x):
        x = self.dark2_csp(self.dark2_conv(self.stem(x)))
        d3 = self.dark3_csp(self.dark3_conv(x))
        d4 = self.dark4_csp(self.dark4_conv(d3))
        d5 = self.dark5_csp(self.dark5_spp(self.dark5_conv(d4)))
        return [d3, d4, d5]
