"""Post-training int8 quantization for serving (counterpart of
frlw_evd_tpu/models/quantize.py), with the int8 conv kernel `int8_conv2d`.

The design is the JAX package's:
- symmetric per-output-channel weight scales, sw[c] = max|W[c]| / 127
  floored at 1e-12, quantized once from the f32 master weights
  (`build_weight_table`);
- symmetric per-tensor activation scales from a calibration pass over
  representative batches (`calibrate_int8`), so the conv's zero padding is
  code 0 exactly;
- int32 accumulation, then the f32 dequant (sw * sx)[c], the bias, and a
  cast to the activation's dtype; BatchNorm and the activation follow as
  usual.

Only plain convs (`nn.Conv2d`, groups 1, no dilation) with at least
MIN_CHANNELS (64, the JAX default) input AND output channels are sites. That keeps the
prediction convs (out <= num_classes + 5), the BFM stem's grouped
weight-norm convs and its narrow mixer, and the fused patchify conv
(`PatchFusedConv2d`, which like the JAX package's `_PatchFusedConv2d` is
not a plain conv) in the serving dtype. A site's key is its module path
joined with "/", which is the flax path of the JAX module (the port's
module names are the flax names, weights.py), so scales and tables carry
over between the two packages; tables hold OIHW codes.

`int8_ctx(model, scales, table)` swaps each calibrated site's forward for
`int8_conv2d` while it is active, and leaves the rest of the model as it
is; with empty scales it does nothing. For torch.export,
`int8_modules_(model, scales, table)` replaces each calibrated conv by an
`Int8Conv` module that holds the site's codes and scales as buffers and
calls the registered operator frlw_evd_torch::int8_conv2d (ops.py). On CUDA tensors `int8_conv2d`
launches `csrc/int8_conv.cu` (wgmma s8 tensor cores, TMA-fed weights, the
activation quantized where it arrives, bf16 channels_last activations),
tiled by `tile_plan`, or raises; on CPU tensors it runs the plain twin
`int8_conv2d_plain`.

The merged head towers (heads.YOLOXHead with `merged`) run their convs
outside the canonical conv modules, so they take part through the head's
`merged_hook`, keyed by the CANONICAL per-branch conv paths, as the JAX
package's `maybe_merged_int8_conv` (quantize.py:62-122): calibration
records each branch's input range under its canonical key (the two
layer-0 branches share one input; layer 1's halves are recorded
separately), and `int8_ctx` serves layer 0 as one site of Cout 2W (the
branches' codes concatenated, the input quantized once with branch 0's sx
and every branch dequantized with that same sx) and layer 1 as one
launch per group, each half with its own sx (`MergedSites`). Scales and
tables are interchangeable between merged and canonical builds.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _build
from .heads import YOLOXHead

MIN_CHANNELS = 64
QMAX = 127


def quantize_kernel(weight: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of an OIHW kernel
    (quantize.py:174-183): returns (q int8 OIHW, sw f32 (O,)) with
    q[c] = clip(round_half_even(W[c] / sw[c]), -127, 127)."""
    w = weight.detach().float()
    sw = (w.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w / sw[:, None, None, None]), -QMAX, QMAX)
    return q.to(torch.int8), sw


def iter_conv_kernels(state_dict):
    """(key, kernel) for every conv-shaped (4-D) weight of a state_dict,
    the key its module path joined with "/" (quantize.py:186-199)."""
    for name, value in state_dict.items():
        if name.endswith(".weight") and value.dim() == 4:
            yield name[:-len(".weight")].replace(".", "/"), value


def build_weight_table(state_dict, scales):
    """{key: (q int8 OIHW, sw f32)} for every calibrated conv, quantized
    once from `state_dict` (the f32 masters, so that the codes do not
    inherit a bf16 round trip; quantize.py:202-212)."""
    return {key: quantize_kernel(w) for key, w in iter_conv_kernels(state_dict)
            if key in scales}


def eligible(module: nn.Module) -> bool:
    """A plain 2-D conv, groups 1, no dilation, at least MIN_CHANNELS
    input and output channels (quantize.py:145-162)."""
    return (type(module) is nn.Conv2d and module.groups == 1
            and tuple(module.dilation) == (1, 1)
            and module.padding_mode == "zeros"
            and module.in_channels >= MIN_CHANNELS
            and module.out_channels >= MIN_CHANNELS)


def eligible_sites(model: nn.Module):
    """{key: conv} of the model's sites, in module order."""
    return {name.replace(".", "/"): mod for name, mod in model.named_modules()
            if eligible(mod)}


def merged_heads(model: nn.Module):
    """{key prefix: head} of the model's YOLOX heads with merged towers
    whose tower convs are sites (width >= MIN_CHANNELS)."""
    return {name.replace(".", "/"): mod for name, mod in model.named_modules()
            if isinstance(mod, YOLOXHead) and mod.merged
            and mod.width >= MIN_CHANNELS}


def tower_keys(prefix: str, k: int, layer: int):
    """The canonical site keys of level k's two tower convs at `layer`,
    cls then reg (heads.py:91-92)."""
    return [f"{prefix}/{b}_convs_{k}_{layer}/conv" for b in ("cls", "reg")]


def merged_parts(h, layer: int):
    """Each branch's input of a merged tower conv: the shared input at
    layer 0, the channel halves at layer 1 (quantize.py:80-84)."""
    if layer == 0:
        return [h, h]
    w = h.shape[1] // 2
    return [h[:, :w], h[:, w:]]


@torch.inference_mode()
def calibrate_int8(model: nn.Module, batches):
    """Activation scales from `model(batch)` over the calibration batches
    (quantize.py:215-254): forward pre-hooks on the sites record max|x| in
    f32 as device tensors, read back once at the end. Returns
    {key: sx} with sx = max(amax, 1e-12) / 127 in Python float."""
    amax: dict[str, torch.Tensor] = {}

    def hook(key):
        def record(_module, args):
            m = args[0].detach().float().abs().amax()
            amax[key] = m if key not in amax else torch.maximum(amax[key], m)
        return record

    def record_merged(prefix):
        def record(k, layer, h):
            for key, part in zip(tower_keys(prefix, k, layer),
                                 merged_parts(h, layer)):
                m = part.detach().float().abs().amax()
                amax[key] = (m if key not in amax
                             else torch.maximum(amax[key], m))
            return None                   # the plain conv runs
        return record

    handles = [mod.register_forward_pre_hook(hook(key))
               for key, mod in eligible_sites(model).items()]
    heads = merged_heads(model)
    for prefix, head in heads.items():
        head.merged_hook = record_merged(prefix)
    try:
        for batch in batches:
            model(batch)
    finally:
        for h in handles:
            h.remove()
        for head in heads.values():
            head.merged_hook = None
    if not amax:
        return {}
    keys = list(amax)
    values = torch.stack([amax[k] for k in keys]).cpu().tolist()
    return {k: max(v, 1e-12) / 127.0 for k, v in zip(keys, values)}


def _f32(value: float) -> float:
    return float(np.float32(value))


def quantize_activation(x: torch.Tensor, inv: float) -> torch.Tensor:
    """clip(round_half_even(f32(x) * f32(inv)), -127, 127), as f32 codes
    (quantize.py:281-282)."""
    inv_t = torch.tensor(_f32(inv), dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() * inv_t), -QMAX, QMAX)


def _out_size(size: int, k: int, stride: int) -> int:
    pad = (k - 1) // 2
    return (size + 2 * pad - k) // stride + 1


def int8_conv2d_plain(x, wq, scale, inv, bias=None, *, stride: int = 1,
                      return_acc: bool = False):
    """Plain-PyTorch twin of `int8_conv2d` (any device): the codes of x,
    then F.conv2d in f64 on the int8 codes, which is exact (|acc| <=
    127^2 * Cin * k^2 < 2^53), cast to int32, dequantized in f32 as
    f32(acc) * scale (+ bias) and cast to x's dtype."""
    k = wq.shape[1]
    xq = quantize_activation(x, inv).double()
    acc = F.conv2d(xq, wq.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=(k - 1) // 2).to(torch.int32)
    out = acc.float() * scale.view(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    out = out.to(x.dtype)
    return (out, acc) if return_acc else out


def check_site(cin: int, cout: int, k: int, stride: int) -> None:
    """Raise unless int8_conv2d takes the shape: k in {1, 3}, stride in
    {1, 2}, Cin a multiple of 32, Cout a multiple of 8."""
    if k not in (1, 3) or stride not in (1, 2) or cin % 32 or cout % 8:
        raise ValueError(f"int8_conv2d takes k in (1, 3), stride in (1, 2), "
                         f"Cin % 32 == 0 and Cout % 8 == 0; got k={k}, "
                         f"stride={stride}, Cin={cin}, Cout={cout}")


# The kernel's tiling (csrc/int8_conv.cu): wgmma widths it is built for, K
# bytes a pipeline stage, slabs its activation copies run ahead, shared
# memory a block may take on an H100, the SMs that its grid fills.
WGMMA_N = (8, 16, 32, 64, 128, 256)
SLAB = 128
AHEAD = 2
SMEM_MAX = 232448
SMS = 132
MAX_STAGES = 4
EPI_BYTES = 16 * 48   # a consumer warp's epilogue scratch (kEpiBytes)


class TilePlan(NamedTuple):
    bm: int       # tile rows (64 per consumer warpgroup)
    bn: int       # output channels a tile (a wgmma width)
    stages: int   # weight (and activation) stages in the ring
    smem: int     # dynamic shared memory bytes
    grid: int     # blocks, each walking tiles grid apart
    tiles: int    # (row tiles) x (channel tiles), row-major
    producers: int  # producer warpgroups
    halo: bool    # int8_conv_halo: rows walk its grid (halo_grid)
    rows: int     # the rows the tiles cover: N Ho Wo, or N Hg Wg
    slab: int     # K bytes of a weight TMA box: 128, or a 64-channel block
    pingpong: bool  # two consumer warpgroups on alternate 64-row tiles


def plan_bn(cout: int) -> int:
    """The tile's output channels: the least wgmma width that holds all
    of Cout, so that each activation slab is quantized once a tap; 256
    (several channel tiles) past that."""
    return next((n for n in WGMMA_N if n >= cout), WGMMA_N[-1])


def halo_grid(h: int, w: int, stride: int):
    """(Hg, Wg, Ph) of the halo kernel: the grid its tile rows walk per
    image (the padded raster, or one parity plane of it at stride 2) and
    the halo positions a tile needs in each plane
    (csrc/int8_conv.cu::int8_conv_halo)."""
    if stride == 1:
        return h + 2, w + 2, 128 + 2 * (w + 2) + 2
    return (h + 3) // 2, (w + 3) // 2, 128 + (w + 3) // 2 + 1


def _halo_bytes(w: int, cb: int, stride: int) -> int:
    """Shared memory of the halo kernel's two halo stages: cb / 16 chunks
    of 16 channels, stride^2 planes of Ph positions rounded up to 8 k + 1,
    16 bytes each."""
    ph = halo_grid(1, w, stride)[2]
    return 2 * (cb // 16) * stride * stride * ((ph + 6) // 8 * 8 + 1) * 16


@functools.lru_cache(maxsize=None)
def tile_plan(n: int, h: int, w: int, cin: int, cout: int, k: int,
              stride: int) -> TilePlan:
    """How int8_conv2d tiles a site (the C entry takes the result as it
    is). 3x3 sites take the halo kernel where its halo and two weight
    stages fit: 128-row tiles of its grid (halo_grid), the activation
    quantized once for the nine taps, in blocks of 128 channels where Cin
    allows and they fit, else (stride 1 only) 64. 1x1 sites take 64-pixel
    tiles, two consumer warpgroups on alternate tiles (`pingpong`: one's
    epilogue overlaps the other's products). The others take 128-pixel
    tiles (two consumer warpgroups), or 64-pixel tiles (one) where
    128-pixel ones would leave more than half the SMs idle (small batches;
    at B = 128 the 8x10 sites ran faster as 80 tiles of 128 than as 160 of
    64 on an H100). Both with AHEAD + 1 bf16 staging slabs of bm x 2 SLAB
    bytes and two producer warpgroups, one where two consumer warpgroups
    at BN = 256 leave no registers for a fourth. BN from `plan_bn`; one
    persistent block an SM (at most one tile each when tiles are fewer);
    as many stages as fit, up to MAX_STAGES, in SMEM_MAX bytes with 1024
    bytes of alignment slack, 8-byte barriers and each consumer warp's
    EPI_BYTES of epilogue scratch."""
    bn = plan_bn(cout)
    gy = -(-cout // bn)
    # the halo's channel blocks to try: 64-channel ones at stride 2 ran
    # slower than the general kernel on an H100 (four planes of halo for
    # two wgmma a weight stage)
    blocks = ()
    if k == 3 and cin % 64 == 0:
        blocks = (SLAB, 64) if cin % SLAB == 0 else (64,)
        if stride == 2:
            blocks = blocks[:1] if SLAB in blocks else ()
    for cb in blocks:
        fixed = 1024 + _halo_bytes(w, cb, stride) + 32 + 8 * EPI_BYTES
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // (bn * cb + 16))
        if stages >= 2:
            hg, wg, _ = halo_grid(h, w, stride)
            rows = n * hg * wg
            tiles = -(-rows // 128) * gy
            return TilePlan(128, bn, stages, fixed + stages * (bn * cb + 16),
                            min(tiles, SMS), tiles, 1, True, rows, cb, False)
    m = n * _out_size(h, k, stride) * _out_size(w, k, stride)
    pingpong = k == 1
    bm = 64 if pingpong or 2 * -(-m // 128) * gy <= SMS else 128
    tiles = -(-m // bm) * gy
    warps = 8 if pingpong else bm // 16        # consumer warps
    fixed = 1024 + (AHEAD + 1) * bm * 2 * SLAB + warps * EPI_BYTES
    stage = (bm + bn) * SLAB + 16
    stages = min(MAX_STAGES, (SMEM_MAX - fixed) // stage)
    if pingpong:
        stages -= stages % 2        # each consumer owns half the ring
    producers = 1 if warps == 8 and bn == 256 else 2
    return TilePlan(bm, bn, stages, fixed + stages * stage, min(tiles, SMS),
                    tiles, producers, False, m, SLAB, pingpong)


def plan_tiles(plan: TilePlan, block: int, cout: int):
    """[(rows, channels)] ranges of the tiles that `block` of the grid
    computes, as the kernel walks them (tile t = block, block + grid, ...;
    row tile t // channel tiles, channel tile t % channel tiles), cut to
    (plan.rows, cout). Rows are output pixels, or padded positions in a
    halo plan."""
    gy = -(-cout // plan.bn)
    out = []
    for t in range(block, plan.tiles, plan.grid):
        m0, n0 = t // gy * plan.bm, t % gy * plan.bn
        out.append((range(m0, min(m0 + plan.bm, plan.rows)),
                    range(n0, min(n0 + plan.bn, cout))))
    return out


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """The (Cout, k*k*Cin) int8 matrix that the kernel's TMA map reads: a
    view of the OHWI codes, K in (tap, channel) order, no copy."""
    return wq.reshape(wq.shape[0], -1)


def weight_map(wq: torch.Tensor, slab: int = SLAB) -> torch.Tensor:
    """The TMA map of the CUDA codes `wq` (OHWI int8, contiguous) at the
    site's BN in boxes of `slab` K bytes (a plan's `slab`), as 128 bytes
    on the host: encoded once a site (Int8Site), it spares each launch the
    encode. Valid while wq lives."""
    mat = weight_matrix(wq)
    out = torch.empty(128, dtype=torch.uint8)
    fn = _build.load("int8_conv").int8_conv_weight_map
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    _build.check(fn(mat.data_ptr(), out.data_ptr(), mat.shape[0],
                    mat.shape[1], plan_bn(mat.shape[0]), slab),
                 "int8_conv_weight_map")
    return out


def int8_conv2d(x, wq, scale, inv, bias=None, *, stride: int = 1,
                return_acc: bool = False):
    """int8 convolution of one site: quantize x with f32 `inv` (1 / sx),
    convolve the codes with `wq` in int32 (padding (k - 1) / 2), scale each
    output channel by `scale` (f32(sw * sx)), add `bias`, cast to x's dtype.

    Args:
      x: (N, Cin, H, W) activation; on CUDA bf16 (any memory format; the
        kernel reads it channels_last).
      wq: (Cout, k, k, Cin) int8 codes (OHWI: the kernel's K order).
      scale, bias: (Cout,) f32; bias may be None.
      inv: the activation scale's reciprocal, rounded to f32.
    Returns (N, Cout, Ho, Wo) in x's dtype (channels_last on CUDA), and the
    int32 sums as well when `return_acc`.

    CPU tensors run the twin; CUDA tensors launch csrc/int8_conv.cu with
    `tile_plan`'s tiling through `_launch`, as an Int8Site does, encoding
    the weights' TMA map for the call (an Int8Site encodes it once), each
    launch counted in `int8_conv2d.launches`, or raise.
    """
    N, cin, H, W = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    check_site(cin, cout, k, stride)
    if wq.dtype != torch.int8 or wq.shape != (cout, k, k, cin):
        raise ValueError(f"wq must be ({cout}, {k}, {k}, {cin}) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if scale.shape != (cout,) or scale.dtype != torch.float32 or (
            bias is not None and (bias.shape != (cout,)
                                  or bias.dtype != torch.float32)):
        raise ValueError(f"scale and bias must be ({cout},) float32")
    for name, t in (("wq", wq), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, wq, scale, inv, bias, stride=stride,
                                 return_acc=return_acc)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8_conv2d reads a bf16 activation on CUDA, got "
                         f"{x.dtype}")
    return _launch(x, wq.contiguous(), scale.contiguous(),
                   None if bias is None else bias.contiguous(),
                   _f32_bits(inv), clamp_bits(_f32(inv)), stride, {},
                   return_acc)


def _f32_bits(value: float) -> int:
    return struct.unpack("<i", struct.pack("<f", _f32(value)))[0]


@functools.lru_cache(maxsize=None)
def clamp_bits(inv: float) -> int:
    """The bits of the largest bf16 B > 0 with f32(B * f32(inv)) < 127.5:
    the kernel clamps x to [-B, B] in bf16 (two instructions for two
    values) in place of clipping f32(x) * inv to [-127, 127], and gets the
    same codes, since f32(B * inv) > 126.5 rounds to 127 as the clip does
    (bf16 values lie at most 2^-7 apart relatively, 0.99 of a code at
    127). Raises if no finite bf16 reaches 126.5 (sx near the f32 range)."""
    bits = np.arange(1, 0x7F80, dtype=np.uint32)   # positive finite bf16
    with np.errstate(over="ignore"):                # inf is past 127.5
        prod = (bits << 16).view(np.float32) * np.float32(_f32(inv))
    below = prod < np.float32(127.5)                # a prefix: prod rises
    n = int(below.sum())
    if n == 0 or n == len(bits) or not prod[n - 1] > np.float32(126.5):
        raise ValueError(f"int8_conv2d: no bf16 clamp for inv = {inv}")
    return int(bits[n - 1])


def _launch(x, wq, scale, bias, inv_bits: int, clamp: int, stride: int,
            wmaps, return_acc: bool = False):
    """Launch csrc/int8_conv.cu on checked CUDA operands (bf16 x on the
    operands' device, contiguous OHWI wq, f32 scale and bias; wmaps the
    {slab: weight_map(wq, slab)} of wq, filled here as plans ask): the one
    place that launches the kernel and counts a launch."""
    N, cin, H, W = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x and wq must be 16-byte aligned")
    plan = tile_plan(N, H, W, cin, cout, k, stride)
    wmap = wmaps.get(plan.slab)
    if wmap is None:
        wmap = wmaps[plan.slab] = weight_map(wq, plan.slab)
    ho, wo = _out_size(H, k, stride), _out_size(W, k, stride)
    out = torch.empty(N, ho, wo, cout, dtype=torch.bfloat16,
                      device=x.device).permute(0, 3, 1, 2)
    acc = (torch.empty(N, ho, wo, cout, dtype=torch.int32,
                       device=x.device).permute(0, 3, 1, 2)
           if return_acc else None)
    _build.launch("int8_conv", "int8_conv2d",
                  (x, scale, bias, out, acc, wmap),
                  (N, H, W, cin, cout, k, stride, inv_bits, clamp, plan.bm,
                   plan.bn, plan.stages, plan.smem, plan.grid,
                   plan.producers, plan.slab if plan.halo else 0,
                   int(plan.pingpong)),
                  x.device)
    int8_conv2d.launches += 1
    return (out, acc) if return_acc else out


int8_conv2d.launches = 0


class Int8Site:
    """One calibrated site, ready for the kernel: of OIHW codes `q` (a
    square kernel, padding (k-1)/2) with weight scales `sw` and activation
    scale `sx`, the OHWI codes, the f32 dequant scale f32(sw * sx), the
    bias, f32(1 / sx) and the stride, on `device` (q's when None); on CUDA
    also the codes' TMA maps (`weight_map`, one a slab size its plans
    take)."""

    def __init__(self, q: torch.Tensor, sw: torch.Tensor, sx: float,
                 stride: int = 1, bias=None, device=None):
        dev = torch.device(q.device if device is None else device)
        cout, cin, k = q.shape[0], q.shape[1], q.shape[-1]
        check_site(cin, cout, k, stride)
        self.stride = stride
        self.inv = _f32(1.0 / sx)
        self.wq = q.permute(0, 2, 3, 1).contiguous().to(dev)
        self.scale = (sw.float().cpu()
                      * torch.tensor(sx, dtype=torch.float32)).to(dev)
        self.bias = None if bias is None else bias.detach().float().to(dev)
        self.wmaps = ({SLAB: weight_map(self.wq)} if dev.type == "cuda"
                      else None)
        self.inv_bits = _f32_bits(self.inv)
        self.clamp = clamp_bits(self.inv) if dev.type == "cuda" else None
        self.cin = cin

    def __call__(self, x):
        if (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
                and x.shape[1] == self.cin and x.device == self.wq.device):
            # the operands were checked here once: launch at once
            return _launch(x, self.wq, self.scale, self.bias, self.inv_bits,
                           self.clamp, self.stride, self.wmaps)
        return int8_conv2d(x, self.wq, self.scale, self.inv, self.bias,
                           stride=self.stride)


class MergedSites:
    """The int8 sites of a merged head (quantize.py:62-122), keyed
    (k, layer) where both branches' canonical keys are calibrated (else
    that conv stays plain, as in JAX): layer 0 one Int8Site of Cout 2W on
    the concatenated codes, its input quantized once with the cls branch's
    sx and both branches dequantized with it; layer 1 one Int8Site a
    group, each on its own half of the input with its own sx (a copy of
    the half: the kernel reads a contiguous channels_last activation).
    Called as the head's merged_hook."""

    def __init__(self, prefix: str, head, scales, table):
        self.sites = {}
        for k in range(len(head.strides)):
            for layer in (0, 1):
                keys = tower_keys(prefix, k, layer)
                if any(key not in scales for key in keys):
                    continue
                convs = [getattr(head, f"{b}_convs_{k}_{layer}").conv
                         for b in ("cls", "reg")]
                codes = [table[key] if key in table
                         else quantize_kernel(conv.weight)
                         for key, conv in zip(keys, convs)]
                dev = convs[0].weight.device
                if layer == 0:
                    self.sites[k, 0] = [Int8Site(
                        torch.cat([q for q, _ in codes]),
                        torch.cat([sw for _, sw in codes]),
                        scales[keys[0]], device=dev)]
                else:
                    self.sites[k, 1] = [
                        Int8Site(q, sw, scales[key], device=dev)
                        for (q, sw), key in zip(codes, keys)]

    def __call__(self, k: int, layer: int, h):
        sites = self.sites.get((k, layer))
        if sites is None:
            return None
        if layer == 0:
            return sites[0](h)
        return torch.cat([site(part) for site, part in
                          zip(sites, merged_parts(h, 1))], dim=1)


class int8_ctx:  # noqa: N801 (used as a context manager, like the JAX one)
    """While active, each site of `model` that `scales` calibrates runs
    `int8_conv2d` (quantize.py:295-314), and so do the towers of each
    merged head (`MergedSites`, in `merged` by the head's key prefix); the
    rest of the model is untouched. Keys of `scales` that are no site of
    the model are ignored, and a site missing from `table` is quantized
    from its live weight, as the JAX interceptor does. The sites are
    prepared once, here, so one context serves every forward it wraps; a
    site the kernel does not take raises here. Empty scales make it a
    no-op. act_dtype: when given, each site's input is cast to it before
    the site quantizes it and the output cast back to the input's dtype
    (an f32 network on the card, whose kernel reads bf16, passes
    torch.bfloat16: its plain version is int8_conv2d_plain on the
    bf16-rounded input, on either device); None quantizes the input as it
    comes."""

    def __init__(self, model: nn.Module, scales, table=None, *,
                 act_dtype=None):
        table, scales = table or {}, scales or {}
        self.sites, self.merged = {}, {}
        self.act_dtype = act_dtype
        if not scales:
            return
        heads = merged_heads(model)
        for prefix, head in heads.items():
            self.merged[prefix] = (head, MergedSites(prefix, head, scales,
                                                     table))
        towers = {key for prefix, head in heads.items()
                  for k in range(len(head.strides)) for layer in (0, 1)
                  for key in tower_keys(prefix, k, layer)}
        for key, conv in eligible_sites(model).items():
            if key not in scales or key in towers:
                continue
            k, stride = conv.kernel_size[0], conv.stride[0]
            if (conv.kernel_size[1] != k or conv.stride[1] != stride
                    or tuple(conv.padding) != ((k - 1) // 2,) * 2):
                raise ValueError(f"int8 site {key} {conv}: the kernel takes "
                                 f"square kernels, equal strides and "
                                 f"padding (k-1)/2")
            q, sw = table[key] if key in table else quantize_kernel(
                conv.weight)
            self.sites[key] = (conv, Int8Site(q, sw, scales[key], stride,
                                              conv.bias, conv.weight.device))

    def __enter__(self):
        for conv, site in self.sites.values():
            conv.forward = self._cast(site)
        for head, sites in self.merged.values():
            head.merged_hook = self._cast(sites)
        return self

    def _cast(self, site):
        """site (an Int8Site, or MergedSites on (k, layer, h)) on its last
        argument cast to act_dtype, its output cast back."""
        if self.act_dtype is None:
            return site

        def call(*args):
            *rest, x = args
            out = site(*rest, x.to(self.act_dtype))
            return None if out is None else out.to(x.dtype)
        return call

    def __exit__(self, *exc):
        for conv, _ in self.sites.values():
            del conv.forward
        for head, _ in self.merged.values():
            head.merged_hook = None
        return False


class Int8Conv(nn.Module):
    """A calibrated site as a module, for torch.export (models/quantize.py
    of the JAX package lowers its sites into the exported program): the
    OHWI codes, the dequant scale f32(sw * sx) and the bias as buffers,
    f32(1 / sx) and the stride as attributes; forward calls the operator
    frlw_evd_torch::int8_conv2d, so a traced program holds one opaque call
    a site and the kernel runs when the program does."""

    def __init__(self, site: Int8Site):
        super().__init__()
        self.register_buffer("wq", site.wq)
        self.register_buffer("scale", site.scale)
        self.register_buffer("bias", site.bias)
        self.inv = site.inv
        self.stride = site.stride

    def forward(self, x):
        return torch.ops.frlw_evd_torch.int8_conv2d(
            x, self.wq, self.scale, self.inv, self.bias, self.stride)


def int8_modules_(model: nn.Module, scales, table=None) -> int:
    """Replace IN PLACE each site of `model` that `scales` calibrates by an
    Int8Conv on int8_ctx's sites (the codes from `table`, else from the
    live weight); returns the number replaced. A merged head's towers are
    refused (their sites are not conv modules)."""
    if merged_heads(model) and scales:
        raise ValueError("int8_modules_: the merged head's tower sites are "
                         "not conv modules; build the canonical head")
    ctx = int8_ctx(model, scales, table)
    for key, (_, site) in ctx.sites.items():
        parent, _, name = key.replace("/", ".").rpartition(".")
        setattr(model.get_submodule(parent), name, Int8Conv(site))
    return len(ctx.sites)
