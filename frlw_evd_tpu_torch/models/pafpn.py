"""YOLO PAN-FPN neck (counterpart of frlw_evd_tpu/models/pafpn.py)."""

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
