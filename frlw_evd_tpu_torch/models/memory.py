"""Recurrent feature memory (counterpart of frlw_evd_tpu/models/memory.py).

Each cell maps (carry, x) → (carry, y): the state is threaded by the caller
across windows, never kept in the module. The cells run NCHW, carries
included; the detectors convert carries to and from the JAX layout (NHWC)
at their boundary (`carries_nchw`, `carries_nhwc`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import (BaseConv, BatchNorm2d, PromotingConv2d,
                     get_activation)


def _map_carries(fn, carries):
    if carries is None:
        return None
    if isinstance(carries, (tuple, list)):
        return tuple(_map_carries(fn, c) for c in carries)
    return fn(carries)


def carries_nchw(carries):
    """A nest of NHWC carries (tuples, None leaves) → NCHW views."""
    return _map_carries(lambda t: t.permute(0, 3, 1, 2), carries)


def carries_nhwc(carries):
    """A nest of NCHW carries → NHWC views (the JAX layout)."""
    return _map_carries(lambda t: t.permute(0, 2, 3, 1), carries)


def _zeros_like_map(ref: torch.Tensor, channels: int, dtype) -> torch.Tensor:
    """Zeros of ref's batch and spatial size with `channels`, in ref's
    memory format (channels_last on the card)."""
    n, _, h, w = ref.shape
    fmt = (torch.channels_last
           if ref.is_contiguous(memory_format=torch.channels_last)
           and not ref.is_contiguous() else torch.contiguous_format)
    return torch.zeros((n, channels, h, w), dtype=dtype, device=ref.device
                       ).contiguous(memory_format=fmt)


class ConvLSTMCell(nn.Module):
    """Input-conv + rnn-conv ConvLSTM (memory.py:20-57): gates split in
    i, f, c, o order. A None carry starts as zeros of the input's dtype.
    Each conv computes in the wider of its input's and its weight's dtypes
    (PromotingConv2d), as flax does: an f32 carry under bf16 weights
    makes the cell's outputs f32."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.stride = stride
        pad = kernel_size // 2
        self.input_conv = PromotingConv2d(in_channels, 4 * hidden_dim,
                                          kernel_size, stride, pad)
        self.rnn_conv = PromotingConv2d(hidden_dim, 4 * hidden_dim,
                                        kernel_size, 1, pad)

    def forward(self, carry, x):
        """carry: None or (h, c) NCHW; x NCHW → ((h, c), h)."""
        x_conv = self.input_conv(x)
        if carry is None:
            zeros = _zeros_like_map(x_conv, self.hidden_dim, x.dtype)
            carry = (zeros, zeros)
        h_cur, c_cur = carry
        h_conv = self.rnn_conv(h_cur)
        x_i, x_f, x_c, x_o = x_conv.chunk(4, 1)
        h_i, h_f, h_c, h_o = h_conv.chunk(4, 1)
        f = torch.sigmoid(x_f + h_f)
        i = torch.sigmoid(x_i + h_i)
        g = torch.tanh(x_c + h_c)
        c_next = f * c_cur + i * g
        o = torch.sigmoid(x_o + h_o)
        h_next = o * torch.tanh(c_next)
        return (h_next, c_next), h_next

    def init_carry(self, n, h, w, dtype=torch.float32, device=None):
        """Zero (h, c), NCHW, of the input size floor-divided by the
        stride (memory.py:54-57)."""
        shape = (n, self.hidden_dim, h // self.stride, w // self.stride)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


class _BottleneckPostAct(nn.Module):
    """Bottleneck with the activation after the residual add
    (memory.py:60-80); conv3 is conv + BN without activation, and the
    residual is added only when the channels match."""

    def __init__(self, in_channels: int, out_channels: int,
                 act: str = "relu"):
        super().__init__()
        self.residual = in_channels == out_channels
        self.conv1 = BaseConv(in_channels, out_channels, 1, act=act)
        self.conv2 = BaseConv(out_channels, out_channels, 3, act=act)
        self.conv3_conv = nn.Conv2d(out_channels, out_channels, 1,
                                    bias=False)
        self.conv3_bn = BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)

    def forward(self, x):
        y = self.conv3_bn(self.conv3_conv(self.conv2(self.conv1(x))))
        if self.residual:
            y = y + x
        return self.act(y)


class ConvGRUCell(nn.Module):
    """recConvCell (memory.py:83-114): a ConvGRU from post-act
    bottlenecks and depthwise 3x3 gate BaseConvs `wr`, `wz`, `wH`, whose
    activation (ReLU) runs before the sigmoid, as JAX's does. A None carry
    starts as zeros of the input's dtype; a given carry must have it."""

    def __init__(self, in_channels: int, hidden_dim: int, act: str = "relu"):
        super().__init__()
        self.hidden_dim = hidden_dim
        cat = hidden_dim + in_channels
        self.bconv1 = _BottleneckPostAct(cat, hidden_dim, act)
        self.bconv2 = _BottleneckPostAct(cat, hidden_dim, act)
        for gate in ("wr", "wz", "wH"):
            self.add_module(gate, BaseConv(hidden_dim, hidden_dim, 3,
                                           groups=hidden_dim, act=act))

    def forward(self, carry, x):
        """carry: None or h NCHW; x NCHW → (h, h)."""
        h1 = (_zeros_like_map(x, self.hidden_dim, x.dtype) if carry is None
              else carry)
        mh1 = self.bconv1(torch.cat([h1, x], 1))
        r = torch.sigmoid(self.wr(mh1))
        z = torch.sigmoid(self.wz(mh1))
        mr = self.bconv2(torch.cat([h1 * r, x], 1))
        H = torch.sigmoid(self.wH(mr))
        h = z * H + (1 - z) * h1
        return h, h


class MemoryModel(nn.Module):
    """Per-FPN-level memory cells `lstms_{i}` (memory.py:117-149): cell i
    on feature level i, threading a tuple of carries. Each level's
    features have its hidden_dims channels, as every caller of JAX's has
    them (JAX reads them from the input). The ConvLSTMs are 3x3, JAX's
    default kernel_sizes, which no caller changes."""

    def __init__(self, cell_type: str = "convlstm",
                 hidden_dims: Sequence[int] = (256, 256, 256),
                 act: str = "relu"):
        super().__init__()
        if cell_type not in ("convlstm", "convgru"):
            raise ValueError(f"cell_type must be convlstm or convgru, got "
                             f"{cell_type!r}")
        for i, d in enumerate(hidden_dims):
            cell = (ConvLSTMCell(d, d, 3) if cell_type == "convlstm"
                    else ConvGRUCell(d, d, act))
            self.add_module(f"lstms_{i}", cell)

    def forward(self, carries, features):
        new_carries, outs = [], []
        for i, (carry, feat) in enumerate(zip(carries, features)):
            c, y = getattr(self, f"lstms_{i}")(carry, feat)
            new_carries.append(c)
            outs.append(y)
        return tuple(new_carries), outs
