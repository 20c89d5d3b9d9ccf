"""Network building blocks (counterpart of frlw_evd_tpu/models/blocks.py).

NCHW `nn.Module`s. Submodule names follow the JAX package's flax names
(`conv`, `bn`, `layer1`, `m_0`, ...), so a flax variable path maps to the
port's state_dict key by joining it with dots (see `weights.py`). The JAX
package's SpmdBatchNorm is `BatchNorm2d` below: plain BatchNorm (eps 1e-5)
at eval, flax's statistics in training.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: str = "silu") -> Callable:
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.1)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    raise ValueError(f"Unsupported act type: {name}")


class PatchFusedConv2d(nn.Module):
    """3x3 conv over a 2x2-patchified grid, applied to the raw grid as one
    6x6 stride-2 conv (blocks.py:149-174).

    conv3x3(space_to_depth_patches(x)) equals conv6x6_s2(x, W6) with
    W6[o, c, 2a+sy, 2b+sx] = W3[o, (2sx+sy)*C + c, a, b] (patch channel
    order [tl, bl, tr, br] = block 2sx+sy). The parameter keeps the
    canonical (O, 4C, 3, 3) shape, so checkpoints carry over unchanged."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, 4 * in_channels,
                                               3, 3))

    def forward(self, x):
        O, C4 = self.weight.shape[:2]
        w6 = self.weight.view(O, 2, 2, C4 // 4, 3, 3)     # (o, sx, sy, c, a, b)
        w6 = w6.permute(0, 3, 4, 2, 5, 1).reshape(O, C4 // 4, 6, 6)
        return F.conv2d(x, w6, stride=2, padding=2)


class PromotingConv2d(nn.Conv2d):
    """nn.Conv2d that computes in the wider of its input's and its
    weight's dtypes, as flax's nn.Conv promotes them (a bf16 kernel on an
    f32 input gives an f32 output); torch's conv refuses mixed dtypes."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


MOMENTUM = 0.9          # flax's momentum (torch's 0.1), blocks.py:200


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics (blocks.py:40-134), under
    nn.BatchNorm2d's state_dict names.

    Training mode normalises with the batch's biased variance, as torch
    does, but updates the running variance with the biased variance too
    (running = 0.9 * running + 0.1 * batch), where nn.BatchNorm2d uses the
    unbiased one, n / (n - 1) larger. The statistics come out of the one
    batch-norm call that normalises: it writes the batch mean and unbiased
    variance into scratch buffers (momentum 1), which are scaled back by
    (n - 1) / n, one rounding more than flax's. They are reduced in at
    least f32 whatever the input's dtype (torch centres the variance where
    flax takes E[x^2] - E[x]^2: equal to f32 rounding), and the running
    statistics keep their dtype (f32 under bf16 compute). With
    `update_stats` False a training forward normalises as always and
    leaves the running statistics alone (the recompute of a
    rematerialised forward, train.make_train_step with remat).

    Eval runs nn.BatchNorm2d's own path when the input has the running
    statistics' dtype (the serving models, cast whole). Under bf16 compute
    copies over f32 statistics (train.make_eval_step) it normalises in f32
    and returns the input's dtype, as flax does.
    """

    update_stats = True

    def forward(self, x):
        if not self.training:
            if x.dtype == self.running_mean.dtype:
                return super().forward(x)
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight.float(),
                                self.bias.float(), False, 0.0,
                                self.eps).to(x.dtype)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
        if self.update_stats:
            update_running_(self, mean, var)
        return y


def batch_norm_train(x, weight, bias, eps: float):
    """Training-mode BatchNorm of NCHW x on its batch statistics:
    (y in x's dtype, the batch mean, its biased variance), the statistics
    reduced in at least f32. They come out of the one batch-norm call that
    normalises (momentum 1 into scratch buffers: the mean and the unbiased
    variance), the variance scaled back by (n - 1) / n."""
    stat = torch.promote_types(x.dtype, torch.float32)
    mean = torch.zeros(x.shape[1], dtype=stat, device=x.device)
    unbiased = torch.zeros_like(mean)
    y = F.batch_norm(x, mean, unbiased, weight.to(stat), bias.to(stat), True,
                     1.0, eps)
    n = x.numel() // x.shape[1]
    return y, mean, unbiased * ((n - 1) / n)


@torch.no_grad()
def update_running_(bn: nn.BatchNorm2d, mean, var) -> None:
    """flax's running update: running = 0.9 * running + 0.1 * batch."""
    bn.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
    bn.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)


class Dropout(nn.Module):
    """flax's nn.Dropout (stems.py:124, :126): in training, each element
    is kept with probability 1 - rate and scaled by 1 / (1 - rate), else
    zeroed; the identity at eval or at rate 0. The masks come from
    `generator`, a torch.Generator on the input's device that the train
    step sets (F.dropout takes none), so one seed gives one set of masks."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training needs its generator set "
                               "(the train step sets it)")
        keep = 1.0 - self.rate
        # the uniforms in x's memory layout (channels_last on the card),
        # so the select runs as one contiguous pass
        u = torch.empty_like(x, dtype=torch.float32)
        mask = u.uniform_(generator=self.generator) < keep
        return torch.where(mask, x / keep, 0.0)


class BaseConv(nn.Module):
    """Conv2d → BatchNorm → dropout → activation (blocks.py:177-221); the
    dropout (`drop`, flax's rate `dropout`) only where dropout > 0, as
    TemporalActiveFocus3D's fusing conv has it.

    patchify_fused=True takes the raw (pre-patchify) grid with
    `in_channels` channels and applies patchify + 3x3 conv as one 6x6
    stride-2 conv (the Focus / BFM stem configuration)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 act: str = "silu", patchify_fused: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        if patchify_fused:
            if (ksize, stride, groups, bias, dropout) != (3, 1, 1, False,
                                                          0.0):
                raise ValueError("patchify_fused needs ksize=3, stride=1, "
                                 "groups=1, bias=False, dropout=0")
            self.conv = PatchFusedConv2d(in_channels, out_channels)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                                  (ksize - 1) // 2, groups=groups, bias=bias)
        self.bn = BatchNorm2d(out_channels, eps=1e-5)
        self.drop = Dropout(dropout) if dropout > 0 else None
        self.act = get_activation(act)

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.drop is not None:
            x = self.drop(x)
        return self.act(x)


class DWConv(nn.Module):
    """Depthwise ksize conv → pointwise 1x1 conv, each a BaseConv
    (blocks.py:224-238). The depthwise weight is (C, 1, k, k), torch's
    layout of flax's (k, k, 1, C) kernel."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act)
        self.pconv = BaseConv(in_channels, out_channels, 1, act=act)

    def forward(self, x):
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    """Standard bottleneck (blocks.py:241); depthwise makes its 3x3 conv a
    DWConv."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        conv = DWConv if depthwise else BaseConv
        self.conv1 = BaseConv(in_channels, hidden, 1, act=act)
        self.conv2 = conv(hidden, out_channels, 3, act=act)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add else y


class ResLayer(nn.Module):
    """1x1 halve → 3x3 restore → add (blocks.py:261)."""

    def __init__(self, in_channels: int, act: str = "silu"):
        super().__init__()
        self.layer1 = BaseConv(in_channels, in_channels // 2, 1, act=act)
        self.layer2 = BaseConv(in_channels // 2, in_channels, 3, act=act)

    def forward(self, x):
        return x + self.layer2(self.layer1(x))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (blocks.py:275)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = BaseConv(in_channels, hidden, 1, act=act)
        self.conv2 = BaseConv(hidden * (len(self.kernel_sizes) + 1),
                              out_channels, 1, act=act)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, ks, stride=1, padding=ks // 2)
                 for ks in self.kernel_sizes]
        return self.conv2(torch.cat([x] + pools, dim=1))


class CSPLayer(nn.Module):
    """C3 / CSP bottleneck with 3 convs (blocks.py:295)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.n = n
        self.conv1 = BaseConv(in_channels, hidden, 1, act=act)
        self.conv2 = BaseConv(in_channels, hidden, 1, act=act)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(hidden, hidden, shortcut,
                                                 1.0, depthwise, act=act))
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, act=act)

    def forward(self, x):
        x1 = self.conv1(x)
        for i in range(self.n):
            x1 = getattr(self, f"m_{i}")(x1)
        return self.conv3(torch.cat([x1, self.conv2(x)], dim=1))


def space_to_depth_patches(x: torch.Tensor) -> torch.Tensor:
    """2x2 patchify of an NHWC tensor with the reference channel order
    (top_left, bot_left, top_right, bot_right) — blocks.py:317-324."""
    tl = x[:, ::2, ::2, :]
    tr = x[:, ::2, 1::2, :]
    bl = x[:, 1::2, ::2, :]
    br = x[:, 1::2, 1::2, :]
    return torch.cat([tl, bl, tr, br], dim=-1)


class Focus(nn.Module):
    """Space-to-depth stem (blocks.py:327), as the fused 6x6 stride-2 conv;
    takes the NHWC (N, H, W, C) volume."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu"):
        super().__init__()
        if ksize != 3:
            raise ValueError("the port's Focus stem is the fused ksize=3 form")
        self.conv = BaseConv(in_channels, out_channels, 3, act=act,
                             patchify_fused=True)

    def forward(self, x):
        return self.conv(x.permute(0, 3, 1, 2))
