"""TAF input stems (counterpart of frlw_evd_tpu/models/stems.py).

`BinsFusionModule` is the BFM stem of the AED serving path: a cascade of
grouped weight-normalised 1x1 convs that halves the number of time bins at
each level and keeps the first `embed_dim` channels of each, an MLP channel
mixer with a residual, then the fused patchify + 3x3 conv. The input
channels are (bin, polarity) interleaved, c = 2*bin + p.

Each stem takes the detector's input in the JAX layout and owns its
conversion to NCHW: the canonical stems an NHWC (N, H, W, 2K) volume, the
p64 stems the patchified volume (N, H/2, W/2, 4*2K) with s-major subpixel
blocks [tl, bl, tr, br], and `BinsFusionModuleFolded` its folded form
(N, H/2, (W/2)*64). Every BFM variant has the parameters of
`BinsFusionModule` under the same state_dict names and shapes, so one
checkpoint serves them all.
"""

from __future__ import annotations

from math import log2

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, get_activation
from .stem_chain import bfm_chain_apply, bfm_chain_apply_folded

S = 4                # subpixel blocks of a patchified pixel


def _nchw(x):
    """NHWC → NCHW view (channels_last in memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


class WeightNormConv1x1(nn.Module):
    """Grouped 1x1 conv with weight normalisation (stems.py:25-57):
    w = g * v / sqrt(sum(v^2) + 1e-12), the sum over every dim except the
    output one. Parameters carry torch's weight_norm names and layout
    (`weight_v` (O, I/groups, 1, 1), `weight_g` (O,)), but the norm is
    computed here with the JAX package's 1e-12 guard. tile=T applies the
    same conv to T consecutive channel blocks (the subpixel blocks of a
    patchified input), with the canonical parameter shapes."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 1,
                 tile: int = 1):
        super().__init__()
        self.groups = groups
        self.tile = tile
        self.weight_v = nn.Parameter(torch.empty(out_channels,
                                                 in_channels // groups, 1, 1))
        self.weight_g = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        v = self.weight_v
        norm = torch.sqrt((v * v).sum(dim=(1, 2, 3)) + 1e-12)
        w = v * (self.weight_g / norm).view(-1, 1, 1, 1)
        return F.conv2d(x, w.repeat(self.tile, 1, 1, 1),
                        self.bias.repeat(self.tile),
                        groups=self.groups * self.tile)


class TiledConv1x1(nn.Module):
    """Dense 1x1 conv with canonical (O, I, 1, 1) parameters, applied to
    `tile` consecutive channel blocks with shared weights (stems.py:60-87);
    parameter names match nn.Conv2d."""

    def __init__(self, in_channels: int, out_channels: int, tile: int = 1):
        super().__init__()
        self.tile = tile
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        return F.conv2d(x, self.weight.repeat(self.tile, 1, 1, 1),
                        self.bias.repeat(self.tile), groups=self.tile)


class _BFMChain(nn.Module):
    """The BFM channel chain's modules (convs_i, trans_up, trans_down) under
    the canonical names and shapes, shared by every BFM stem. tile=4 applies
    them per subpixel block of a patchified input. The stems whose chain
    runs in kernel B4 or B7 hand the kernel `chain_params()`."""

    def __init__(self, in_channels: int, embed_dim: int, act: str,
                 tile: int = 1):
        super().__init__()
        tc = in_channels // 2
        self.levels = int(log2(tc))
        self.embed_dim = embed_dim
        self.act_name = act
        self.act = get_activation(act)
        cin = in_channels
        for i in range(self.levels):
            out_ch = embed_dim * tc // 2
            self.add_module(f"convs_{i}",
                            WeightNormConv1x1(cin, out_ch, groups=tc // 2,
                                              tile=tile))
            cin = out_ch
            tc //= 2
        self.mixer = embed_dim * self.levels
        self.trans_up = TiledConv1x1(self.mixer, self.mixer * 4, tile=tile)
        self.trans_down = TiledConv1x1(self.mixer * 4, self.mixer, tile=tile)

    def chain_params(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in self.named_parameters()
                if not k.startswith("conv.")}


class BinsFusionModule(_BFMChain):
    """BFM stem (stems.py:90-134). in_channels must be 2K. Dropout is a
    no-op at eval and is not modelled."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 4):
        if ksize != 3:
            raise ValueError("the port's BFM stem is the fused ksize=3 form")
        super().__init__(in_channels, embed_dim, act)
        self.conv = BaseConv(self.mixer, out_channels, 3, act=act,
                             patchify_fused=True)

    def forward(self, x):
        """x: (N, H, W, 2K) → (N, out, H/2, W/2)."""
        xout = []
        h = _nchw(x)
        for i in range(self.levels):
            h = F.relu(getattr(self, f"convs_{i}")(h))
            xout.append(h[:, :self.embed_dim])
        h = torch.cat(xout, dim=1)
        h = h + self.trans_down(self.act(self.trans_up(h)))
        return self.conv(h)


class BinsFusionModulePatched(_BFMChain):
    """BFM stem for the patchified volume (N, H/2, W/2, 4*2K), in plain ops
    (stems.py:137-191): the 1x1 chain runs per subpixel block with shared
    weights (tiled), then a plain 3x3 conv over the 4*12 channels, which
    equals the canonical BFM on the raw grid. in_channels is 2K."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 4):
        super().__init__(in_channels, embed_dim, act, tile=S)
        self.conv = BaseConv(S * self.mixer, out_channels, ksize, act=act)

    def forward(self, x):
        """x: (N, H/2, W/2, 4*2K) → (N, out, H/2, W/2)."""
        xout = []
        h = _nchw(x)
        N, _, H2, W2 = h.shape
        for i in range(self.levels):
            h = F.relu(getattr(self, f"convs_{i}")(h))
            xout.append(h.view(N, S, -1, H2, W2)[:, :, :self.embed_dim])
        h = torch.cat(xout, dim=2).reshape(N, -1, H2, W2)
        h = h + self.trans_down(self.act(self.trans_up(h)))
        return self.conv(h)


class BinsFusionModulePatchedKernel(_BFMChain):
    """BinsFusionModulePatched with the chain in kernel B7
    (stems.py:224-260), at eval; then a plain 3x3 BaseConv over its 48
    channels."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 4):
        super().__init__(in_channels, embed_dim, act)
        self.conv = BaseConv(S * self.mixer, out_channels, ksize, act=act)

    def forward(self, x):
        """x: (N, H/2, W/2, 4*2K) → (N, out, H/2, W/2)."""
        h = bfm_chain_apply(x.to(torch.bfloat16), self.chain_params(),
                            act=self.act_name)
        return self.conv(_nchw(h).to(self.trans_up.weight.dtype))


class PadKernelConv2d(nn.Module):
    """3x3 conv with canonical (O, real_in, k, k) weight applied to an input
    whose channels past real_in are zero: the weight is zero-padded to the
    input's channels (stems.py:334-352). Like the JAX module it computes in
    the input's dtype, casting the weight to it."""

    def __init__(self, real_in: int, out_channels: int, ksize: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, real_in, ksize,
                                               ksize))

    def forward(self, x):
        w = self.weight.to(x.dtype)
        w = F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))
        return F.conv2d(x, w, padding=(w.shape[-1] - 1) // 2)


class _PadInBaseConv(nn.Module):
    """PadKernelConv2d → BatchNorm → act (stems.py:313-331); the BatchNorm
    computes in its parameters' dtype."""

    def __init__(self, real_in: int, out_channels: int, ksize: int = 3,
                 act: str = "silu"):
        super().__init__()
        self.conv = PadKernelConv2d(real_in, out_channels, ksize)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x).to(self.bn.weight.dtype)))


class BinsFusionModuleFolded(_BFMChain):
    """BFM stem for the folded patchified volume (N, H/2, (W/2)*64)
    (stems.py:263-310), at eval: the chain in kernel B4, which writes 48
    channels and 16 zeros per pixel, then the canonical (O, 48, 3, 3) conv
    zero-padded to 64 input channels."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 4):
        super().__init__(in_channels, embed_dim, act)
        self.pixel_channels = S * in_channels
        self.conv = _PadInBaseConv(S * self.mixer, out_channels, ksize,
                                   act=act)

    def forward(self, x_f):
        """x_f: (N, H/2, (W/2)*64) → (N, out, H/2, W/2)."""
        N, H2, WF = x_f.shape
        W2 = WF // self.pixel_channels
        h = bfm_chain_apply_folded(x_f.to(torch.bfloat16),
                                   self.chain_params(), act=self.act_name,
                                   width=W2)
        return self.conv(_nchw(h.view(N, H2, W2, self.pixel_channels)))


class FocusPatched(nn.Module):
    """Focus stem for the patchified volume (stems.py:355-366): the plain
    3x3 conv, with Focus's (O, 4C, 3, 3) parameter."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu"):
        super().__init__()
        self.conv = BaseConv(S * in_channels, out_channels, ksize, act=act)

    def forward(self, x):
        """x: (N, H/2, W/2, 4C) → (N, out, H/2, W/2)."""
        return self.conv(_nchw(x))
