"""Necks: the YOLO PAN-FPN and the plain YOLOv3-style FPN (counterpart of
frlw_evd_tpu/models/pafpn.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, CSPLayer


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest 2x upsample (pafpn.py:15-19)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """PAN-FPN over (dark3, dark4, dark5) (pafpn.py:22-60), with the same
    concat order. AED: depth=0.33, in_channels=(256, 256, 256)."""

    def __init__(self, depth: float = 0.33,
                 in_channels: Sequence[int] = (256, 256, 256),
                 act: str = "silu"):
        super().__init__()
        n = round(3 * depth)
        c0, c1, c2 = (int(c) for c in in_channels)
        self.lateral_conv0 = BaseConv(c2, c1, 1, act=act)
        self.C3_p4 = CSPLayer(2 * c1, c1, n=n, shortcut=False, act=act)
        self.reduce_conv1 = BaseConv(c1, c0, 1, act=act)
        self.C3_p3 = CSPLayer(2 * c0, c0, n=n, shortcut=False, act=act)
        self.bu_conv2 = BaseConv(c0, c0, 3, 2, act=act)
        self.C3_n3 = CSPLayer(2 * c0, c1, n=n, shortcut=False, act=act)
        self.bu_conv1 = BaseConv(c1, c1, 3, 2, act=act)
        self.C3_n4 = CSPLayer(2 * c1, c2, n=n, shortcut=False, act=act)

    def forward(self, features):
        x2, x1, x0 = features    # dark3, dark4, dark5
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([upsample_nearest_2x(fpn_out0), x1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([upsample_nearest_2x(fpn_out1), x2],
                                        1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1))
        return [pan_out2, pan_out1, pan_out0]


class _ConvSet(nn.Module):
    """YOLOv3 embedding block: 5 alternating 1x1 / 3x3 BaseConvs
    (pafpn.py:63-78)."""

    def __init__(self, in_filters: int, filters: int, act: str = "lrelu"):
        super().__init__()
        f = filters
        self.conv0 = BaseConv(in_filters, f, 1, act=act)
        self.conv1 = BaseConv(f, f * 2, 3, act=act)
        self.conv2 = BaseConv(f * 2, f, 1, act=act)
        self.conv3 = BaseConv(f, f * 2, 3, act=act)
        self.conv4 = BaseConv(f * 2, f, 1, act=act)

    def forward(self, x):
        return self.conv4(self.conv3(self.conv2(self.conv1(self.conv0(x)))))


class YOLOFPN(nn.Module):
    """Plain YOLOv3-style FPN with the nearest upsample (pafpn.py:81-98)
    over (x2, x1, x0) of `in_channels`, which JAX reads from the inputs;
    returns [out2, out1, out0] of (128, 256, 512)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "lrelu"):
        super().__init__()
        c2, c1, c0 = (int(c) for c in in_channels)
        self.out0_embed = _ConvSet(c0, 512, act=act)
        self.out1_cbl = BaseConv(512, 256, 1, act=act)
        self.out1_embed = _ConvSet(256 + c1, 256, act=act)
        self.out2_cbl = BaseConv(256, 128, 1, act=act)
        self.out2_embed = _ConvSet(128 + c2, 128, act=act)

    def forward(self, features):
        x2, x1, x0 = features
        out0 = self.out0_embed(x0)
        up0 = upsample_nearest_2x(self.out1_cbl(out0))
        out1 = self.out1_embed(torch.cat([up0, x1], 1))
        up1 = upsample_nearest_2x(self.out2_cbl(out1))
        out2 = self.out2_embed(torch.cat([up1, x2], 1))
        return [out2, out1, out0]
