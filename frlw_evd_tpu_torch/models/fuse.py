"""Inference-time conv+BN folding (counterpart of
frlw_evd_tpu/models/fuse.py; reference: core/yolox/utils/model_utils.py
fuse_conv_and_bn:31).

Folds every BatchNorm that follows a conv in the `BaseConv`-style blocks
(sibling `conv` and `bn` modules) into the conv's weight and rewrites the
BatchNorm as identity, on the port's state_dict.
"""

from __future__ import annotations

import torch


def fuse_conv_bn_params(state_dict, eps: float = 1e-5):
    """Return a state_dict, loadable by the same model, in which every
    sibling pair `<p>.conv.weight` + `<p>.bn.{weight, bias, running_mean,
    running_var}` is folded (fuse.py:19-71):

        W' = W * scale / sqrt(var + eps)       (per output channel)
        b' = bias - scale * mean / sqrt(var + eps)   (+ conv bias * factor)

    The fused bias lives in the BatchNorm, which becomes the identity up to
    f32 rounding: weight 1, bias b', running_mean 0, running_var 1 - eps. A
    conv bias, where there is one, is folded into b' and set to 0. The
    arithmetic is the JAX function's, in f32."""
    out = dict(state_dict)
    for key, var in state_dict.items():
        if key.split(".")[-2:] != ["bn", "running_var"]:
            continue
        p = key[:-len("bn.running_var")]
        conv = state_dict.get(p + "conv.weight")
        if conv is None or conv.dim() != 4:
            continue
        gamma, beta = state_dict[p + "bn.weight"], state_dict[p + "bn.bias"]
        mean = state_dict[p + "bn.running_mean"]
        rstd = torch.rsqrt(var + eps)
        factor = gamma * rstd
        out[p + "conv.weight"] = conv * factor[:, None, None, None]
        fused_bias = beta - gamma * mean * rstd
        if p + "conv.bias" in state_dict:
            fused_bias = fused_bias + state_dict[p + "conv.bias"] * factor
            out[p + "conv.bias"] = torch.zeros_like(state_dict[p +
                                                               "conv.bias"])
        out[p + "bn.weight"] = torch.ones_like(gamma)
        out[p + "bn.bias"] = fused_bias
        out[p + "bn.running_mean"] = torch.zeros_like(mean)
        out[p + "bn.running_var"] = torch.full_like(var, 1.0 - eps)
    return out
