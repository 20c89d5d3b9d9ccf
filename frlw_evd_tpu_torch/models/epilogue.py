"""The conv blocks' eval epilogue: BatchNorm, activation and residual add
in one pass over a conv's bf16 channels_last output (`csrc/bn_act.cu`).

    bn_act(x, mean, var, weight, bias, eps, act, residual, gate)
      = bf16(act((x - mean) * rsqrt(var + eps) * weight + bias)
             (+ [gate[n, c] *] residual))

every step in f32 and one rounding to bf16. `blocks.BaseConv`, the folded
1 Mpx stem's conv and RED's SE-ResNet sites (`red.SEBottleneck`, whose
`down` site adds the SE-gated shortcut, gate (N, C), with the identity
activation "linear") take it at eval when their output shows that it
applies (`blocks.conv_epilogue`); everything else keeps the separate
BatchNorm, activation, gate and add.

Why: served in bf16 on the card, cuDNN runs each conv, and torch ran the
eval BatchNorm, the activation and the ResLayers' add as three more
passes over its output: at 1 Mpx, B = 128, 62 sites a window, 8.6 ms of
BatchNorm transform, 6.0 of silu and 1.5 of adds in a 43 ms step
(PERF.md §5). One pass moves 19.1 GB a step where the three moved 39.5.

CPU tensors run the plain twin `bn_act_plain`; CUDA tensors launch the
kernel (each launch counted in `bn_act.launches`) or raise. What the
kernel takes is written once, in `refusal`, which `bn_act` and
`blocks.conv_epilogue` ask; `apply` runs operands that passed it. A fused
site calls `apply` eagerly and the operator `frlw_evd_torch::bn_act`
(ops.py, which calls `bn_act`) while torch.export traces, so that the
trace holds it as one opaque call: on the card the operator's dispatch
costs the host 12-13 us a site more than the direct call (chip_smoke.py
phase 47), 0.8 ms a forward of 62 sites.
"""

from __future__ import annotations

import struct

import torch
import torch.nn.functional as F

from ..kernels import _build

# the kernel's activations (csrc/bn_act.cu's template cases), by the names
# blocks.get_activation takes
_ACT_CODE = {"silu": 0, "relu": 1, "lrelu": 2, "linear": 3}
MAX_CHANNELS = 2048         # 256 groups of 8: one group a thread of a block
THREADS = 256
BLOCKS_PER_SM = 4
# the device whose tensors fuse (blocks.conv_epilogue); the CPU tests set
# "cpu" to run the twin on the fused route (`apply`)
KERNEL_DEVICE = "cuda"
_PARAM_DTYPES = (torch.bfloat16, torch.float32)

_sm_count: dict[int, int] = {}


def bn_act_plain(x, mean, var, weight, bias, eps: float, act: str,
                 residual=None, gate=None):
    """The twin: f32 batch_norm on the f32 parameters, the activation, the
    residual (times the gate) added in f32, one rounding to x's dtype."""
    from .blocks import get_activation      # blocks imports this module

    y = F.batch_norm(x.float(), mean.float(), var.float(), weight.float(),
                     bias.float(), False, 0.0, eps)
    y = get_activation(act)(y)
    if gate is not None:
        y = y + gate_map(gate).float() * residual.float()
    elif residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def gate_map(gate):
    """A gate of (N, C) or (N, C, 1, 1) as (N, C, 1, 1), to broadcast over
    the residual's pixels."""
    return gate.reshape(*gate.shape[:2], 1, 1)


def refusal(x, mean, var, weight, bias, act: str, residual=None,
            gate=None, *, traced: bool = False):
    """Why the kernel does not take these operands, or None where it does:
    x (N, C, H, W) bf16 with C % 8 == 0 and C <= MAX_CHANNELS,
    channels_last-contiguous and 16-byte aligned; the residual None or laid
    out as x; the gate None, or (N, C) or (N, C, 1, 1) bf16 on x's device,
    contiguous and 16-byte aligned, with a residual; mean and var of one
    dtype, weight and bias of one, each (C,) bf16 or f32 on x's device; act
    one of the kernel's. `traced`: the strides and offsets are a tracer's guess
    (torch.export's fake convs on CUDA give NCHW where cuDNN writes
    channels_last) and are not asked for; the operator lays its inputs out at
    run time."""
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        return f"x must be 4-d bf16, not {x.dtype} {tuple(x.shape)}"
    C = x.shape[1]
    if C % 8 or C > MAX_CHANNELS:
        return f"x needs C % 8 == 0 and C <= {MAX_CHANNELS}, not C = {C}"
    if act not in _ACT_CODE:
        return f"act must be one of {sorted(_ACT_CODE)}, not {act!r}"
    if not traced and (
            x.data_ptr() % 16
            or not x.is_contiguous(memory_format=torch.channels_last)):
        return "x must be channels_last-contiguous and 16-byte aligned"
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or not traced and (residual.stride() != x.stride()
                               or residual.data_ptr() % 16)):
        return "the residual must be laid out as x"
    if gate is not None and (
            residual is None or gate.dtype != torch.bfloat16
            or gate.shape not in ((x.shape[0], C), (x.shape[0], C, 1, 1))
            or gate.device != x.device
            or not traced and (not gate.is_contiguous()
                               or gate.data_ptr() % 16)):
        return (f"the gate must be ({x.shape[0]}, {C}) or "
                f"({x.shape[0]}, {C}, 1, 1) bf16 on {x.device}, "
                f"contiguous and 16-byte aligned, with a residual")
    for a, b in ((mean, var), (weight, bias)):
        if (a is None or b is None or a.dtype not in _PARAM_DTYPES
                or b.dtype != a.dtype
                or any(t.shape != (C,) or t.device != x.device
                       or not t.is_contiguous() for t in (a, b))):
            return (f"the parameters must be ({C},) bf16 or f32 on "
                    f"{x.device}, mean and var of one dtype, weight and "
                    f"bias of one")
    return None


def _f32_bits(value: float) -> int:
    return struct.unpack("<i", struct.pack("<f", value))[0]


def _grid(device, n_pix: int, C: int) -> int:
    sms = _sm_count.get(device.index)
    if sms is None:
        sms = _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    pix_per_block = THREADS // (C // 8)
    return max(1, min(-(-n_pix // pix_per_block), BLOCKS_PER_SM * sms))


def bn_act(x, mean, var, weight, bias, eps: float, act: str,
           residual=None, gate=None):
    """BatchNorm (eval), `act` and the optional residual, optionally
    gated, in one pass.

    Args:
      x: (N, C, H, W) bf16, channels_last-contiguous, C % 8 == 0.
      mean, var, weight, bias: (C,) bf16 or f32 (mean and var of one
        dtype, weight and bias of one dtype).
      act: "silu", "relu", "lrelu" (slope 0.1) or "linear" (the identity).
      residual: None, or a tensor like x.
      gate: None, or (N, C) or (N, C, 1, 1) bf16, contiguous: the residual
        of sample n, channel c is added times gate[n, c].
    Returns (N, C, H, W) bf16 laid out as x.

    CPU tensors run `bn_act_plain`; CUDA tensors launch csrc/bn_act.cu
    (counting the launch in `bn_act.launches`) or raise ValueError with
    `refusal`'s reason."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_act: unsupported device {x.device}")
    if x.device.type == "cuda":
        why = refusal(x, mean, var, weight, bias, act, residual, gate)
        if why is not None:
            raise ValueError(f"bn_act: {why}")
    return apply(x, mean, var, weight, bias, eps, act, residual, gate)


def apply(x, mean, var, weight, bias, eps: float, act: str, residual=None,
          gate=None):
    """`bn_act` on operands that `refusal` passed, unchecked: the twin on
    CPU tensors, one launch of the kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return bn_act_plain(x, mean, var, weight, bias, eps, act, residual,
                            gate)
    N, C, H, W = x.shape
    out = torch.empty_like(x)
    flags = ((mean.dtype == torch.float32)
             | (weight.dtype == torch.float32) << 1)
    _build.launch("bn_act", "bn_act",
                  (x, residual, gate, mean, var, weight, bias, out),
                  (N, H * W, C, _ACT_CODE[act], flags, _f32_bits(eps),
                   _grid(x.device, N * H * W, C)),
                  x.device)
    bn_act.launches += 1
    return out


bn_act.launches = 0
