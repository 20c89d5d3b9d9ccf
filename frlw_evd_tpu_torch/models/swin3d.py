"""Video Swin Transformer 3D and the TAF swin and correlation stems
(counterpart of frlw_evd_tpu/models/swin3d.py).

The reference's customised Video-Swin: 3-D window attention with a
relative position bias, cyclic-shift masking, PatchEmbed3D, the spatial
PatchMerging and the temporal PatchMergingTime (2 → 1 time merge). The
stems `TemporalActiveFocusSwin` ("taf_swin") and `TemporalActiveFocusCorr`
("taf_corr") read the TAF volume (N, H, W, 2K) as a K-frame video of
2-channel frames.

Tokens stay in the JAX layout, (B, D, H, W, C) with the channels last,
since the LayerNorms and Linears act on the last axis; the convolutions
permute to torch's channels-first layout and back, and each stem hands its
final BaseConv an NCHW view. Submodules carry flax's names, so
`weights.load_flax_variables` carries JAX's variables across (Dense
kernels transposed, the Conv3d kernel DHWIO → OIDHW, LayerNorm scale →
weight, the bias tables as they are).

Attention is plain matmul + softmax, the bias and the -100 shift mask
added as JAX adds them. Every op promotes as jnp does: the f32 shift mask
and the corr stem's f32 decay deltas carry f32 through a bf16 forward
(`Linear`, `LayerNorm`, the Conv3d and `blocks.PromotingConv2d` compute in
the wider of their input's and parameters' dtypes). A stem casts its
features to its BaseConv's dtype before that conv, so that under bf16
compute the backbone runs in bf16 as for every other stem; JAX's forward
stays in f32 from there on (ROADMAP §C).

A window is clamped to the input where the input is no larger
(`get_window_size`), and JAX sizes the relative position table by the
clamped window at trace time. The port's blocks are built with the
declared window: a clamp that leaves the window as declared (the swin
stem's last time stage, D = 2) zeroes the shift as in JAX, and an input
that would clamp the window to another size raises. The TAF stems never
clamp at the sizes the repo runs (their windows are (2, 4, 4), D = 2 at
the smallest, H and W larger than 4 after the 2x2 embedding).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, Dropout, PromotingConv2d

MASK = -100.0          # the shift mask's value across regions
LN_EPS = 1e-6          # flax nn.LayerNorm's epsilon
MLP_RATIO = 4          # SwinBlock3D's MLP width over its dim (swin3d.py:143)
DELTAS = (0, 5, 10, 25)  # the corr stem's decay shifts (swin3d.py:428)


def _promoted(*tensors) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


class Linear(nn.Linear):
    """nn.Linear computing in the wider of its input's and its weight's
    dtypes, as flax's nn.Dense promotes them."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last axis: epsilon 1e-6, the
    statistics and the normalisation in at least f32, the result in the
    wider of the input's and the parameters' dtypes."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        out = _promoted(x, self.weight, self.bias)
        stat = torch.promote_types(out, torch.float32)
        y = F.layer_norm(x.to(stat), (x.shape[-1],), self.weight.to(stat),
                         self.bias.to(stat), LN_EPS)
        return y.to(out)


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp the window (and zero the shift) in each dimension where the
    input is no larger than the window (swin3d.py:26-37)."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            if use_shift is not None:
                use_shift[i] = 0
    if shift_size is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


def window_partition(x, window_size):
    """(B, D, H, W, C) → (B*nW, Wd*Wh*Ww, C) (swin3d.py:40-46)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def window_reverse(windows, window_size, B, D, H, W):
    """The inverse of window_partition (swin3d.py:49-53)."""
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


@lru_cache()
def _relative_position_index(window_size: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) rows of the bias table for each pair of a window's tokens
    (swin3d.py:56-70)."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh),
                                  np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache()
def compute_shift_mask(D, H, W, window_size, shift_size) -> np.ndarray:
    """(nW, N, N) additive mask (0 within a region, -100 across) of the
    shifted windows (swin3d.py:73-92). With a shift of 0 in a dimension,
    slice(-0, None) covers the whole axis, so the last region takes it all
    and that dimension is not partitioned, as in the reference."""
    img_mask = np.zeros((1, D, H, W, 1))
    cnt = 0
    wd, wh, ww = window_size
    sd, sh, sw = shift_size
    for d in (slice(-wd), slice(-wd, -sd), slice(-sd, None)):
        for h in (slice(-wh), slice(-wh, -sh), slice(-sh, None)):
            for w in (slice(-ww), slice(-ww, -sw), slice(-sw, None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    x = img_mask.reshape(1, D // wd, wd, H // wh, wh, W // ww, ww, 1)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    mask = x[:, None, :] - x[:, :, None]
    return np.where(mask != 0, MASK, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _on_device(fn, args, device: torch.device) -> torch.Tensor:
    """fn(*args) (a cached numpy table) as a tensor on `device`, copied
    there once."""
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def _bias_rows(window_size, N: int, device) -> torch.Tensor:
    idx = _on_device(_relative_position_index, (tuple(window_size),),
                     torch.device(device))
    return idx[:N, :N].reshape(-1)


def _table(window_size, heads: int) -> nn.Parameter:
    wd, wh, ww = window_size
    return nn.Parameter(torch.zeros((2 * wd - 1) * (2 * wh - 1)
                                    * (2 * ww - 1), heads))


def _matmul(a, b):
    """a @ b in the wider of the two dtypes (jnp.einsum promotes)."""
    dtype = _promoted(a, b)
    return a.to(dtype) @ b.to(dtype)


class WindowAttention3D(nn.Module):
    """W-MSA with the 3-D relative position bias (swin3d.py:95-137):
    x (B*nW, N, C), mask (nW, N, N) or None."""

    def __init__(self, dim: int, window_size: Tuple[int, int, int],
                 num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size = tuple(window_size)
        self.relative_position_bias_table = _table(window_size, num_heads)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        nh = self.num_heads
        hd = self.dim // nh
        qkv = self.qkv(x).reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            _bias_rows(self.window_size, N, x.device)]
        attn = attn + bias.reshape(N, N, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N)
                    + mask[None, :, None]).reshape(-1, nh, N, N)
        out = _matmul(attn.softmax(-1), v)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


def _window_for(x_size, window_size, shift_size=(0, 0, 0)):
    """get_window_size's (window, shift) for an input of `x_size`, raising
    where it clamps the window to another size than declared (module
    docstring)."""
    ws, ss = get_window_size(x_size, window_size, shift_size)
    if ws != tuple(window_size):
        raise ValueError(f"an input of {tuple(x_size)} clamps the window "
                         f"{tuple(window_size)} to {ws}")
    return ws, ss


class SwinBlock3D(nn.Module):
    """Swin block: (S)W-MSA + MLP with pre-norm residuals
    (swin3d.py:140-182). The MLP's gelu is jax.nn.gelu's default, the tanh
    form."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 shift_size: Tuple[int, int, int] = (0, 0, 0)):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(
            shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, self.window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, dim * MLP_RATIO)
        self.mlp_fc2 = Linear(dim * MLP_RATIO, dim)

    def forward(self, x):
        B, D, H, W, C = x.shape
        window_size, shift_size = _window_for((D, H, W), self.window_size,
                                              self.shift_size)
        shifted = any(s > 0 for s in shift_size)
        h = self.norm1(x)
        pad = [(-n) % w for n, w in zip((D, H, W), window_size)]
        h = F.pad(h, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        _, Dp, Hp, Wp, _ = h.shape
        mask = None
        if shifted:
            h = torch.roll(h, [-s for s in shift_size], dims=(1, 2, 3))
            mask = _on_device(compute_shift_mask,
                              (Dp, Hp, Wp, window_size, shift_size),
                              x.device)
        h = self.attn(window_partition(h, window_size), mask)
        h = window_reverse(h, window_size, B, Dp, Hp, Wp)
        if shifted:
            h = torch.roll(h, list(shift_size), dims=(1, 2, 3))
        x = x + h[:, :D, :H, :W]
        y = self.mlp_fc1(self.norm2(x))
        return x + self.mlp_fc2(F.gelu(y, approximate="tanh"))


class PatchMerging(nn.Module):
    """Spatial 2x2 merge, 4C → 2C (swin3d.py:185-200)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchMergingTime(nn.Module):
    """Temporal 2 → 1 merge, 2C → out_dim (swin3d.py:203-215)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(2 * dim)
        self.reduction = Linear(2 * dim, out_dim)

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = x.reshape(B, D // 2, 2, H, W, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, D // 2, H, W, 2 * C)))


class BasicLayer3D(nn.Module):
    """One Swin stage: W-MSA and SW-MSA blocks in turn (the shift half the
    window in H and W), then an optional downsample: None, "spatial"
    (PatchMerging) or "time" (PatchMergingTime to out_dim)
    (swin3d.py:218-245)."""

    def __init__(self, in_dim: int, out_dim: int, depth: int,
                 num_heads: int,
                 window_size: Tuple[int, int, int] = (1, 7, 7),
                 downsample: Optional[str] = None):
        super().__init__()
        self.depth = depth
        shift = (0, window_size[1] // 2, window_size[2] // 2)
        for i in range(depth):
            self.add_module(f"blocks_{i}", SwinBlock3D(
                in_dim, num_heads, window_size,
                (0, 0, 0) if i % 2 == 0 else shift))
        if downsample == "spatial":
            self.downsample = PatchMerging(in_dim)
        elif downsample == "time":
            self.downsample = PatchMergingTime(in_dim, out_dim)
        elif downsample is None:
            self.downsample = None
        else:
            raise ValueError(f"downsample: None, 'spatial' or 'time', got "
                             f"{downsample!r}")

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed3D(nn.Module):
    """Conv3d patchify of a (B, D, H, W, C) video, zero-padded to whole
    patches, with an optional LayerNorm (swin3d.py:248-266)."""

    def __init__(self, in_chans: int,
                 patch_size: Tuple[int, int, int] = (1, 4, 4),
                 embed_dim: int = 96, use_norm: bool = False):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x):
        B, D, H, W, C = x.shape
        pd, ph, pw = self.patch_size
        x = F.pad(x, (0, 0, 0, (-W) % pw, 0, (-H) % ph, 0, (-D) % pd))
        w, b = self.proj.weight, self.proj.bias
        dtype = _promoted(x, w)
        x = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dtype), w.to(dtype),
                     b.to(dtype), self.patch_size).permute(0, 2, 3, 4, 1)
        return x if self.norm is None else self.norm(x)


class SwinTransformer3D(nn.Module):
    """The reference's customised Video-Swin (swin3d.py:269-307): temporal
    stages first (window (2, *window_hw), PatchMergingTime, the first
    doubling the width), then the 2, 2, 6, 2 spatial pyramid with
    PatchMerging between. Input (B, D, H, W, in_chans); returns the last
    (B, D', H', W', C') map. No stage may clamp its window to another
    size (module docstring): the last spatial stage needs more than
    window_hw tokens in H and W."""

    def __init__(self, in_chans: int, depth_time_stages: int = 2,
                 embed_dim: int = 96, num_heads: int = 3,
                 patch_size: Tuple[int, int, int] = (1, 4, 4),
                 window_hw: Tuple[int, int] = (4, 5)):
        super().__init__()
        self.depth_time_stages = depth_time_stages
        self.patch_embed = PatchEmbed3D(in_chans, patch_size, embed_dim)
        dim = embed_dim
        for i in range(depth_time_stages):
            out_dim = dim * 2 if i == 0 else dim
            self.add_module(f"time_layers_{i}", BasicLayer3D(
                dim, out_dim, 2, num_heads, (2, *window_hw), "time"))
            dim = out_dim
        for j, d in enumerate((2, 2, 6, 2)):
            down = "spatial" if j < 3 else None
            self.add_module(f"layers_{j}", BasicLayer3D(
                dim, dim * 2, d, num_heads * 2 ** j, (1, *window_hw), down))
            if j < 3:
                dim *= 2

    def forward(self, x):
        x = self.patch_embed(x)
        for i in range(self.depth_time_stages):
            x = getattr(self, f"time_layers_{i}")(x)
        for j in range(4):
            x = getattr(self, f"layers_{j}")(x)
        return x


def _video(x):
    """(B, H, W, 2K), channels (bin, polarity) interleaved → the
    (B, K, H, W, 2) video (swin3d.py:321, :439)."""
    B, H, W, C = x.shape
    return x.reshape(B, H, W, C // 2, 2).permute(0, 3, 1, 2, 4)


class TemporalActiveFocusSwin(nn.Module):
    """TAF swin stem (swin3d.py:310-336): the K bins as a K-frame video,
    2-channel frames embedded at (1, 2, 2), temporal Swin stages (depth 2,
    2 heads, window (2, 4, 4), the first doubling the width) until one
    frame is left, then a ksize BaseConv at half resolution. in_channels
    is 2K."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 16):
        super().__init__()
        self.patch_embed = PatchEmbed3D(2, (1, 2, 2), embed_dim)
        dim, d, self.stages = embed_dim, in_channels // 2, 0
        while d > 1:
            out_dim = dim * 2 if self.stages == 0 else dim
            self.add_module(f"time_layers_{self.stages}", BasicLayer3D(
                dim, out_dim, 2, 2, (2, 4, 4), "time"))
            dim, d, self.stages = out_dim, d // 2, self.stages + 1
        self.conv = BaseConv(dim, out_channels, ksize, act=act)

    def forward(self, x):
        """x: (N, H, W, 2K) → (N, out, H/2, W/2)."""
        h = self.patch_embed(_video(x))
        for i in range(self.stages):
            h = getattr(self, f"time_layers_{i}")(h)
        h = h[:, 0].permute(0, 3, 1, 2)
        return self.conv(h.to(self.conv.conv.weight.dtype))


def corr_window_partition(x, window_size):
    """(B, R, D, H, W, C) → (B*nW, R, Wd*Wh*Ww, C) (swin3d.py:344-350)."""
    B, R, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, R, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7, 8)
    return x.reshape(-1, R, wd * wh * ww, C)


def corr_window_reverse(windows, window_size, B, R, D, H, W):
    """The inverse of corr_window_partition (swin3d.py:353-357)."""
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, R, wd, wh, ww, -1)
    return x.permute(0, 4, 1, 5, 2, 6, 3, 7, 8).reshape(B, R, D, H, W, -1)


@lru_cache()
def _corr_position_index(window_size: Tuple[int, int, int]) -> np.ndarray:
    """The (1, wh, ww) index tiled (wd, wd): the bias ignores time
    (swin3d.py:385-389)."""
    wd, wh, ww = window_size
    return np.tile(_relative_position_index((1, wh, ww)), (wd, wd))


class CorrAttention3D(nn.Module):
    """Cross-attention of the TAF tokens with R decay-shifted references
    within 3-D windows (swin3d.py:360-394): the queries and keys from the
    references (the first's queries only), the values from x, a bias per
    reference from a table of (2wd-1)(2wh-1)(2ww-1) rows (JAX's shape,
    so the weights carry across) indexed by the temporal-free index, the
    R outputs reduced to dim by `reduceR`."""

    def __init__(self, dim: int, R: int, window_size: Tuple[int, int, int]):
        super().__init__()
        self.dim, self.R = dim, R
        self.window_size = tuple(window_size)
        self.projv = Linear(dim, dim)
        self.projq = Linear(dim, dim)
        self.projk = Linear(dim, dim)
        self.relative_position_bias_table = _table(window_size, R)
        self.reduceR = Linear(R * dim, dim)

    def forward(self, x, x_ref):
        """x: (Nw, N, C) values; x_ref: (Nw, R, N, C) queries and keys."""
        Nw, R, N, C = x_ref.shape
        v = self.projv(x)
        q = self.projq(x_ref[:, 0]) * self.dim ** -0.5
        k = self.projk(x_ref)
        attn = q[:, None] @ k.transpose(-2, -1)          # (Nw, R, N, N)
        rows = _on_device(_corr_position_index, (self.window_size,),
                          x.device)[:N, :N].reshape(-1)
        bias = self.relative_position_bias_table[rows].reshape(N, N, R)
        attn = attn + bias.permute(2, 0, 1)[None]
        out = _matmul(attn.softmax(-1), v[:, None])      # (Nw, R, N, dim)
        return self.reduceR(out.transpose(1, 2).reshape(Nw, N, R * self.dim))


class CorrLayer3D(nn.Module):
    """Window-partitioned correlation layer (swin3d.py:397-415):
    x (B, 1, D, H, W, C), x_ref (B, R, D, H, W, C) → (B, 1, D, H, W, C).
    D, H and W must be multiples of the window, which the input may not
    clamp to another size (module docstring)."""

    def __init__(self, dim: int, R: int,
                 window_size: Tuple[int, int, int] = (2, 4, 4)):
        super().__init__()
        self.window_size = tuple(window_size)
        self.attn = CorrAttention3D(dim, R, self.window_size)

    def forward(self, x, x_ref):
        B, _, D, H, W, C = x.shape
        ws = _window_for((D, H, W), self.window_size)[0]
        out = self.attn(corr_window_partition(x, ws)[:, 0],
                        corr_window_partition(x_ref, ws))
        return corr_window_reverse(out[:, None], ws, B, 1, D, H, W)


def _conv_nhwc(conv: nn.Conv2d, x):
    """conv of an NHWC tensor → NCHW (channels_last in memory)."""
    return conv(x.permute(0, 3, 1, 2))


class TemporalActiveFocusCorr(nn.Module):
    """TAF correlation stem (swin3d.py:418-487): R decay-shifted copies of
    the volume (age + delta in leaky space, DELTAS), both
    patch-embedded at 2x2, then log2(K) rounds of cross-window correlation
    (CorrLayer3D), each merging adjacent time steps with a LayerNorm, a
    grouped 1x1 conv, relu and dropout 0.1 on the tokens and (but for the
    last round) on the references, then a ksize BaseConv at half
    resolution. The deltas are f32, so the reference chain computes in f32
    under bf16 compute, as in JAX. in_channels is 2K."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 act: str = "silu", embed_dim: int = 16):
        super().__init__()
        d = in_channels // 2
        self.rounds = int(math.log2(d))
        R, dim = len(DELTAS), embed_dim
        self.patch_embed = PromotingConv2d(2, dim, 2, 2)
        self.patch_embed_ref = PromotingConv2d(2, dim, 2, 2)
        self.drops = nn.ModuleList()
        for i in range(self.rounds):
            self.add_module(f"corr_extracts_{i}", CorrLayer3D(dim, R))
            self.add_module(f"layer_norms_{i}", LayerNorm(d * dim))
            self.add_module(f"convs_{i}", PromotingConv2d(
                d * dim, d * dim, 1, groups=max(d // 2, 1)))
            self.drops.append(Dropout(0.1))
            if i < self.rounds - 1:
                self.add_module(f"layer_norms_ref_{i}", LayerNorm(d * dim))
                self.add_module(f"convs_ref_{i}", PromotingConv2d(
                    d * dim, d * dim, 1, groups=max(d // 2, 1)))
                self.drops.append(Dropout(0.1))
            d, dim = d // 2, dim * 2
        self.conv = BaseConv(dim, out_channels, ksize, act=act)

    def forward(self, x):
        """x: (N, H, W, 2K) → (N, out, H/2, W/2)."""
        video = _video(x)                                  # (B, D, H, W, 2)
        B, D, H, W, _ = video.shape
        R = len(DELTAS)
        deltas = torch.tensor(DELTAS, dtype=torch.float32,
                              device=x.device).view(1, R, 1, 1, 1, 1)
        ref = 1.0 - torch.log1p(torch.expm1((1.0 - video[:, None]) * 8.7)
                                + deltas) / 8.7
        h = _conv_nhwc(self.patch_embed, video.reshape(B * D, H, W, 2))
        r = _conv_nhwc(self.patch_embed_ref, ref.reshape(B * R * D, H, W, 2))
        Hp, Wp = h.shape[2:]
        h = h.permute(0, 2, 3, 1).reshape(B, 1, D, Hp, Wp, -1)
        r = r.permute(0, 2, 3, 1).reshape(B, R, D, Hp, Wp, -1)
        d, drops = D, iter(self.drops)
        for i in range(self.rounds):
            h = getattr(self, f"corr_extracts_{i}")(h, r)
            dim = h.shape[-1]
            h2 = h[:, 0].permute(0, 2, 3, 1, 4).reshape(B, Hp, Wp, d * dim)
            h2 = getattr(self, f"layer_norms_{i}")(h2)
            h2 = next(drops)(F.relu(_conv_nhwc(getattr(self, f"convs_{i}"),
                                             h2)))
            d, dim = d // 2, dim * 2
            h = h2.permute(0, 2, 3, 1).reshape(B, Hp, Wp, d, dim).permute(
                0, 3, 1, 2, 4)[:, None]
            if i < self.rounds - 1:
                r2 = r.permute(0, 1, 3, 4, 2, 5).reshape(B * R, Hp, Wp,
                                                         d * dim)
                r2 = getattr(self, f"layer_norms_ref_{i}")(r2)
                r2 = next(drops)(F.relu(_conv_nhwc(
                    getattr(self, f"convs_ref_{i}"), r2)))
                r = r2.permute(0, 2, 3, 1).reshape(B, R, Hp, Wp, d,
                                                   dim).permute(0, 1, 4, 2,
                                                                3, 5)
        h = h[:, 0, 0].permute(0, 3, 1, 2)                # (B, dim, Hp, Wp)
        return self.conv(h.to(self.conv.conv.weight.dtype))


__all__ = ["BasicLayer3D", "CorrAttention3D", "CorrLayer3D", "LayerNorm",
           "Linear", "PatchEmbed3D", "PatchMerging", "PatchMergingTime",
           "SwinBlock3D", "SwinTransformer3D", "TemporalActiveFocusCorr",
           "TemporalActiveFocusSwin", "WindowAttention3D",
           "compute_shift_mask", "corr_window_partition",
           "corr_window_reverse", "get_window_size", "window_partition",
           "window_reverse"]
