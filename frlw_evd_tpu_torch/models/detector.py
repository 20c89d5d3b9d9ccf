"""Composite detector: stem + backbone → neck → head (counterpart of
frlw_evd_tpu/models/detector.py), for the AED family, with its training
loss.

`EventDetector` takes the JAX layout at its boundary and returns per-level
NHWC head maps; inside it runs NCHW (channels_last in memory when the input
is a contiguous NHWC tensor). The stem owns the input layout: an NHWC
volume (N, H, W, 2K) for `focus` and `bfm`, the patchified (N, H/2, W/2,
4*2K) for the p64 stems, and its folded form (N, H/2, (W/2)*64) for
`bfm_folded`.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
from torch import nn

from .blocks import Focus, PatchFusedConv2d
from .darknet import Darknet
from .heads import (YOLOXHead, compute_losses, decode_outputs,
                    flatten_level_outputs, level_grids)
from .pafpn import YOLOPAFPN
from .stems import (BinsFusionModule, BinsFusionModuleFolded,
                    BinsFusionModulePatched, BinsFusionModulePatchedKernel,
                    FocusPatched, PadKernelConv2d, TiledConv1x1,
                    WeightNormConv1x1, _BFMChain)

# the p64 variants have the parameters of focus / bfm (detector.py:93-106)
_STEMS = {"focus": Focus, "bfm": BinsFusionModule, "focus_p64": FocusPatched,
          "bfm_p64": BinsFusionModulePatched,
          "bfm_p64_kernel": BinsFusionModulePatchedKernel,
          "bfm_folded": BinsFusionModuleFolded}


class EventDetector(nn.Module):
    """backbone → neck → head; returns raw per-level maps (detector.py:25)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, x):
        """x: the stem's input volume → [(N, h, w, 4+1+num_classes)] per
        level."""
        feats = self.backbone(x.to(self.dtype))
        return self.head(self.neck(feats))

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype


def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's scales: lecun-normal
    conv kernels (std 1/sqrt(fan_in)), zero conv biases, weight-norm
    v ~ N(0, 0.01) and g = 1, identity BatchNorm, and the YOLOX prior
    bias -log((1-p)/p) on the cls and obj predictors (heads.py:141)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, PatchFusedConv2d, TiledConv1x1,
                                PadKernelConv2d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                   generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, WeightNormConv1x1):
                mod.weight_v.normal_(0.0, 0.01, generator=generator)
                mod.weight_g.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        if isinstance(model, EventDetector):
            head = model.head
            for name, mod in head.named_children():
                if name.startswith(("cls_preds_", "obj_preds_")):
                    mod.bias.fill_(head.prior_bias)


def build_detector(num_classes: int, *, family: str = "aed",
                   stem: str = "focus", act: str = "silu",
                   strides: Sequence[int] = (8, 16, 32),
                   in_channels: Sequence[int] = (256, 256, 256),
                   depth: float = 0.33, stem_out_channels: int = 64,
                   head_width: int = 256, input_channels: int = 16,
                   generator: torch.Generator | None = None,
                   train: bool = False,
                   dropout_rate: float = 0.1) -> EventDetector:
    """AED detector (detector.py:109-143): Darknet-21 + YOLOPAFPN +
    YOLOXHead. stem: one of _STEMS. input_channels is the volume's 2K (per
    subpixel block for the p64 stems).
    Parameters are initialised from `generator` (a fresh seed-0 generator
    when None); the model is on the CPU, in f32, in eval mode, or in
    training mode when `train`. dropout_rate is the BFM stems' dropout in
    training (stems.py:100), taken by every BFM stem; the kernel stems
    refuse training."""
    if family != "aed":
        raise ValueError(f"the port builds family 'aed' only, got {family!r}")
    if stem not in _STEMS:
        raise ValueError(f"the port has stems {sorted(_STEMS)}, got {stem!r}")
    stem_cls = _STEMS[stem]
    if issubclass(stem_cls, _BFMChain):
        stem_cls = partial(stem_cls, dropout_rate=dropout_rate)
    backbone = Darknet(stem_cls, input_channels,
                       stem_out_channels=stem_out_channels,
                       out_channels=tuple(in_channels), act=act)
    neck = YOLOPAFPN(depth=depth, in_channels=tuple(in_channels), act=act)
    head = YOLOXHead(num_classes, tuple(in_channels), strides=strides,
                     width=head_width, act=act)
    model = EventDetector(backbone, neck, head)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters_(model, generator)
    return model.train(train)


def eval_decode(level_outs, strides):
    """Eval-path decode (detector.py:146-153): sigmoid obj/cls, then the
    geometric decode → (N, A, 5 + C)."""
    hw = [tuple(o.shape[1:3]) for o in level_outs]
    x_shift, y_shift, stride = level_grids(hw, strides,
                                           device=level_outs[0].device)
    outputs = flatten_level_outputs(level_outs)
    outputs = torch.cat([outputs[..., :4], torch.sigmoid(outputs[..., 4:])],
                        dim=-1)
    return decode_outputs(outputs, x_shift, y_shift, stride)


def detector_loss(level_outs, labels, strides, num_classes, radius):
    """The SimOTA training loss of the head maps (detector.py:156-158)."""
    hw = [tuple(o.shape[1:3]) for o in level_outs]
    return compute_losses(level_outs, labels, hw, strides, num_classes,
                          radius)


__all__ = ["EventDetector", "build_detector", "detector_loss", "eval_decode",
           "init_parameters_"]
