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
is; with empty scales it does nothing. On CUDA tensors `int8_conv2d`
launches `csrc/int8_conv.cu` (s8 tensor cores, quantize-on-load, bf16
channels_last activations) or raises; on CPU tensors it runs the plain
twin `int8_conv2d_plain`. The JAX package's merged-head hook
(`maybe_merged_int8_conv`) has no counterpart: the merged head towers are
not ported.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import _build

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

    handles = [mod.register_forward_pre_hook(hook(key))
               for key, mod in eligible_sites(model).items()]
    try:
        for batch in batches:
            model(batch)
    finally:
        for h in handles:
            h.remove()
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

    CPU tensors run the twin; CUDA tensors launch csrc/int8_conv.cu (each
    launch counted in `int8_conv2d.launches`) or raise.
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
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    ho, wo = _out_size(H, k, stride), _out_size(W, k, stride)
    out = torch.empty(N, cout, ho, wo, dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    acc = (torch.empty(N, cout, ho, wo, dtype=torch.int32, device=x.device,
                       memory_format=torch.channels_last)
           if return_acc else None)
    inv_bits = struct.unpack("<i", struct.pack("<f", _f32(inv)))[0]
    _build.launch("int8_conv", "int8_conv2d",
                  (x, wq.contiguous(), scale.contiguous(), bias, out, acc),
                  (N, H, W, cin, cout, k, stride, inv_bits), x.device)
    int8_conv2d.launches += 1
    return (out, acc) if return_acc else out


int8_conv2d.launches = 0


class Int8Site:
    """One calibrated site, ready for the kernel: OHWI codes, the f32
    dequant scale f32(sw * sx), the bias, f32(1 / sx) and the stride, on
    the conv's device."""

    def __init__(self, conv: nn.Conv2d, sx: float, q: torch.Tensor,
                 sw: torch.Tensor):
        k, stride = conv.kernel_size[0], conv.stride[0]
        if (conv.kernel_size[0] != conv.kernel_size[1]
                or conv.stride[0] != conv.stride[1]
                or tuple(conv.padding) != ((k - 1) // 2,) * 2):
            raise ValueError(f"int8 site {conv}: the kernel takes square "
                             f"kernels, equal strides and padding (k-1)/2")
        check_site(conv.in_channels, conv.out_channels, k, stride)
        dev = conv.weight.device
        self.stride = stride
        self.inv = _f32(1.0 / sx)
        self.wq = q.permute(0, 2, 3, 1).contiguous().to(dev)
        self.scale = (sw.float().cpu()
                      * torch.tensor(sx, dtype=torch.float32)).to(dev)
        self.bias = (None if conv.bias is None
                     else conv.bias.detach().float().to(dev))

    def __call__(self, x):
        return int8_conv2d(x, self.wq, self.scale, self.inv, self.bias,
                           stride=self.stride)


class int8_ctx:  # noqa: N801 (used as a context manager, like the JAX one)
    """While active, each site of `model` that `scales` calibrates runs
    `int8_conv2d` (quantize.py:295-314); the rest of the model is
    untouched. Keys of `scales` that are no site of the model are ignored,
    and a site missing from `table` is quantized from its live weight, as
    the JAX interceptor does. The sites are prepared once, here, so one
    context serves every forward it wraps; a site the kernel does not take
    raises here. Empty scales make it a no-op."""

    def __init__(self, model: nn.Module, scales, table=None):
        table = table or {}
        self.sites = {}
        for key, conv in eligible_sites(model).items():
            if key not in (scales or {}):
                continue
            q, sw = table[key] if key in table else quantize_kernel(
                conv.weight)
            self.sites[key] = (conv, Int8Site(conv, scales[key], q, sw))

    def __enter__(self):
        for conv, site in self.sites.values():
            conv.forward = site
        return self

    def __exit__(self, *exc):
        for conv, _ in self.sites.values():
            del conv.forward
        return False
