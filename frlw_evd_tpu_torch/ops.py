"""The port's operators registered with torch.library, so that
torch.export traces a hand-written kernel as one opaque operator and a
loaded program calls it again (tools/export_model.py).

frlw_evd_torch::int8_conv2d(x, wq, scale, inv, bias, stride) is
`models/quantize.int8_conv2d`: on CPU tensors its plain twin, on CUDA
tensors csrc/int8_conv.cu, whose tile plan and weight map are worked out
at each call (inside the operator, never while tracing), each launch
counted in `int8_conv2d.launches`. Its fake implementation gives the
output's shape, dtype and layout (channels_last, as the kernel writes it
and the twin's conv does). The package imports this module, so importing
frlw_evd_tpu_torch registers the operator before a `.pt2` that calls it
is loaded.
"""

from __future__ import annotations

from typing import Optional

import torch


def _out_size(size: int, k: int, stride: int) -> int:
    return (size + 2 * ((k - 1) // 2) - k) // stride + 1


@torch.library.custom_op("frlw_evd_torch::int8_conv2d", mutates_args=())
def int8_conv2d(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                inv: float, bias: Optional[torch.Tensor],
                stride: int) -> torch.Tensor:
    from .models.quantize import int8_conv2d as conv

    out = conv(x, wq, scale, inv, bias, stride=stride)
    want = _empty_out(x, wq, stride)
    if out.stride() == want.stride():
        return out
    return want.copy_(out)


def _empty_out(x, wq, stride: int) -> torch.Tensor:
    """The output's (N, Cout, Ho, Wo) in x's dtype, laid out
    channels_last, as the kernel writes it (and the twin's conv)."""
    N, _, H, W = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    ho, wo = _out_size(H, k, stride), _out_size(W, k, stride)
    return x.new_empty((N, ho, wo, cout)).permute(0, 3, 1, 2)


@int8_conv2d.register_fake
def _(x, wq, scale, inv, bias, stride):
    return _empty_out(x, wq, stride)
