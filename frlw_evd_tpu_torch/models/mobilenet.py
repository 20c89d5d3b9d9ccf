"""MobileNetV2 with coordinate attention (counterpart of
frlw_evd_tpu/models/mobilenet.py; reference core/yolox/models/mobilenet.py):
the spare backbone MBV2_CA, which no exp type uses.

NCHW inside; `MBV2CA` takes an NHWC image (N, H, W, C), as the JAX module
does, and returns the (N, num_classes) logits. Submodules carry flax's
names (`stem`, `block_{i}` with `pw`, `dw`, `ca`, `pw_linear`,
`head_conv`, `classifier`), so `weights.load_flax_variables` carries JAX's
variables across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm2d, Dropout


def h_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def h_swish(x):
    return x * h_sigmoid(x)


def _make_divisible(v, divisor, min_value=None):
    """The nearest multiple of divisor, at least min_value and no less
    than 0.9 v (mobilenet.py:24-30)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_ACTS = {"relu6": F.relu6, "hswish": h_swish, "none": lambda x: x}


class _ConvBN(nn.Module):
    """conv (no bias) → BatchNorm → relu6 | hswish | none
    (mobilenet.py:33-55)."""

    def __init__(self, in_channels: int, out: int, ksize: int = 3,
                 stride: int = 1, groups: int = 1, act: str = "relu6"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out, ksize, stride,
                              (ksize - 1) // 2, groups=groups, bias=False)
        self.bn = BatchNorm2d(out, eps=1e-5)
        self.act = _ACTS[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class CoordAtt(nn.Module):
    """Coordinate attention (mobilenet.py:58-81): the H and W profiles
    (means over W and over H) share a 1x1 conv, BatchNorm and h_swish,
    then gate the map along each axis through their own 1x1 convs."""

    def __init__(self, inp: int, oup: int, groups: int = 32):
        super().__init__()
        mip = max(8, inp // groups)
        self.conv1 = nn.Conv2d(inp, mip, 1)
        self.bn1 = BatchNorm2d(mip, eps=1e-5)
        self.conv2 = nn.Conv2d(mip, oup, 1)
        self.conv3 = nn.Conv2d(mip, oup, 1)

    def forward(self, x):
        h = x.shape[2]
        x_h = x.mean(3, keepdim=True)                        # (N, C, H, 1)
        x_w = x.mean(2, keepdim=True).transpose(2, 3)        # (N, C, W, 1)
        y = h_swish(self.bn1(self.conv1(torch.cat([x_h, x_w], dim=2))))
        a_h = torch.sigmoid(self.conv2(y[:, :, :h]))
        a_w = torch.sigmoid(self.conv3(y[:, :, h:].transpose(2, 3)))
        return x * a_w * a_h


class InvertedResidual(nn.Module):
    """MBV2 inverted residual with CoordAtt in the expanded branch
    (mobilenet.py:84-103)."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.identity = stride == 1 and inp == oup
        self.expand = expand_ratio != 1
        if self.expand:
            self.pw = _ConvBN(inp, hidden, 1)
        self.dw = _ConvBN(hidden, hidden, 3, stride, groups=hidden)
        if self.expand:
            self.ca = CoordAtt(hidden, hidden)
        self.pw_linear = _ConvBN(hidden, oup, 1, act="none")

    def forward(self, x):
        y = self.pw(x) if self.expand else x
        y = self.dw(y)
        if self.expand:
            y = self.ca(y)
        y = self.pw_linear(y)
        return x + y if self.identity else y


class MBV2CA(nn.Module):
    """The full MBV2-CA, classifier included (mobilenet.py:106-131):
    the dropout (0.1) before the classifier is the port's Dropout, which
    draws from the generator a train step sets."""

    CFGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, in_channels: int = 3, num_classes: int = 1000,
                 width_mult: float = 1.0):
        super().__init__()
        div = 4 if width_mult == 0.1 else 8
        ch = _make_divisible(32 * width_mult, div)
        self.stem = _ConvBN(in_channels, ch, 3, 2, act="hswish")
        self.blocks = 0
        for t, c, n, s in self.CFGS:
            out = _make_divisible(c * width_mult, div)
            for i in range(n):
                self.add_module(f"block_{self.blocks}", InvertedResidual(
                    ch, out, s if i == 0 else 1, t))
                ch = out
                self.blocks += 1
        out = (_make_divisible(1280 * width_mult, div) if width_mult > 1.0
               else 1280)
        self.head_conv = _ConvBN(ch, out, 1, act="hswish")
        self.drop = Dropout(0.1)
        self.classifier = nn.Linear(out, num_classes)

    def forward(self, x):
        """x: (N, H, W, C) → (N, num_classes)."""
        x = self.stem(x.permute(0, 3, 1, 2))
        for i in range(self.blocks):
            x = getattr(self, f"block_{i}")(x)
        x = self.head_conv(x).mean((2, 3))
        return self.classifier(self.drop(x))


__all__ = ["CoordAtt", "InvertedResidual", "MBV2CA", "h_sigmoid", "h_swish"]
