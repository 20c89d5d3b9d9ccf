"""Composite detectors (counterpart of frlw_evd_tpu/models/detector.py):
stem + backbone → neck → head for the AED and yolox families, with their
training loss, and the recurrent `MemoryEventDetector` (backbone →
per-level ConvLSTM / ConvGRU memory → neck → head) of the convlstm and
recconv families with `rollout_memory_detector`.

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
from .darknet import CSPDarknet, Darknet
from .heads import (YOLOXHead, compute_losses, decode_outputs,
                    flatten_level_outputs, level_grids)
from .memory import MemoryModel, carries_nchw, carries_nhwc
from .pafpn import YOLOPAFPN
from .stems import (BinsFusionModule, BinsFusionModuleFolded,
                    BinsFusionModulePatched, BinsFusionModulePatchedKernel,
                    FocusPatched, PadKernelConv2d, TiledConv1x1,
                    WeightNormConv1x1, _BFMChain)
from .yolov3 import YOLOv3Head

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


class MemoryEventDetector(nn.Module):
    """backbone → per-level recurrent memory → neck → head
    (detector.py:38-55): forward(carries, x) → (carries, head maps), the
    carries in the JAX layout (NHWC) or None for a fresh sequence (zeros
    of the features' dtype)."""

    def __init__(self, backbone: nn.Module, memory: MemoryModel,
                 neck: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.memory = memory
        self.neck = neck
        self.head = head

    def forward(self, carries, x):
        feats = self.backbone(x.to(next(self.parameters()).dtype))
        if carries is None:
            carries = (None,) * len(feats)
        carries, feats = self.memory(carries_nchw(carries), feats)
        return carries_nhwc(carries), self.head(self.neck(feats))


def rollout_memory_detector(model: MemoryEventDetector, windows):
    """Run `model` (in its current mode) over a (T, N, H, W, C) window
    sequence, the carries threaded window to window from None
    (detector.py:161-180, a Python loop where JAX scans). Returns (the last
    carries, the head maps of each level stacked over T)."""
    carries, outs = None, []
    for x in windows:
        carries, maps = model(carries, x)
        outs.append(maps)
    return carries, [torch.stack(level) for level in zip(*outs)]


def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's scales: lecun-normal
    conv kernels (std 1/sqrt(fan_in)), zero conv biases, weight-norm
    v ~ N(0, 0.01) and g = 1, identity BatchNorm, the YOLOX prior bias
    -log((1-p)/p) on the cls and obj predictors (heads.py:141) and, on a
    YOLOv3 head, on the first KA channels of each det conv
    (yolov3.py:169-181)."""
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
        for head in model.modules():
            if isinstance(head, YOLOXHead):
                for name, mod in head.named_children():
                    if name.startswith(("cls_preds_", "obj_preds_")):
                        mod.bias.fill_(head.prior_bias)
            elif isinstance(head, YOLOv3Head):
                head.init_prior_bias_()


def _stem_class(stem: str, dropout_rate: float):
    """The stem module class of `stem`, a BFM stem's with `dropout_rate`."""
    if stem not in _STEMS:
        raise ValueError(f"the port has stems {sorted(_STEMS)}, got {stem!r}")
    stem_cls = _STEMS[stem]
    if issubclass(stem_cls, _BFMChain):
        stem_cls = partial(stem_cls, dropout_rate=dropout_rate)
    return stem_cls


def build_detector(num_classes: int, *, family: str = "aed",
                   stem: str = "focus", act: str = "silu",
                   strides: Sequence[int] = (8, 16, 32),
                   in_channels: Sequence[int] = (256, 256, 256),
                   depth: float = 0.33, stem_out_channels: int = 64,
                   head_width: int = 256, input_channels: int = 16,
                   generator: torch.Generator | None = None,
                   train: bool = False,
                   dropout_rate: float = 0.1) -> EventDetector:
    """The exp-type model matrix (detector.py:109-143). family "aed":
    Darknet-21 + YOLOPAFPN + YOLOXHead, `in_channels` wide; "yolox":
    CSPDarknet (dep_mul 0.33, wid_mul 0.5) + YOLOPAFPN at depth 0.33 over
    its (128, 256, 512) channels + YOLOXHead, as JAX sets them whatever
    `in_channels`, `depth` and `stem_out_channels` say. stem: one of
    _STEMS. input_channels is the volume's 2K (per subpixel block for the
    p64 stems).
    Parameters are initialised from `generator` (a fresh seed-0 generator
    when None); the model is on the CPU, in f32, in eval mode, or in
    training mode when `train`. dropout_rate is the BFM stems' dropout in
    training (stems.py:100), taken by every BFM stem; the kernel stems
    refuse training."""
    stem_cls = _stem_class(stem, dropout_rate)
    if family == "aed":
        backbone = Darknet(stem_cls, input_channels,
                           stem_out_channels=stem_out_channels,
                           out_channels=tuple(in_channels), act=act)
    elif family == "yolox":
        in_channels, depth = (128, 256, 512), 0.33
        backbone = CSPDarknet(stem_cls, input_channels, dep_mul=0.33,
                              wid_mul=0.5, act=act)
    else:
        raise ValueError(f"the port builds families 'aed' and 'yolox', "
                         f"got {family!r}")
    neck = YOLOPAFPN(depth=depth, in_channels=tuple(in_channels), act=act)
    head = YOLOXHead(num_classes, tuple(in_channels), strides=strides,
                     width=head_width, act=act)
    model = EventDetector(backbone, neck, head)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters_(model, generator)
    return model.train(train)


def build_memory_detector(num_classes: int, cell_type: str = "convlstm", *,
                          stem: str = "focus", act: str = "silu",
                          strides: Sequence[int] = (8, 16, 32),
                          in_channels: Sequence[int] = (256, 256, 256),
                          depth: float = 0.33, stem_out_channels: int = 64,
                          head_width: int = 256, input_channels: int = 16,
                          generator: torch.Generator | None = None,
                          train: bool = False,
                          dropout_rate: float = 0.1) -> MemoryEventDetector:
    """The convlstm / recconv model (trainer.py:335-352): Darknet-21 over
    `in_channels`, a MemoryModel of `cell_type` (convlstm | convgru) with
    hidden_dims in_channels and ReLU, YOLOPAFPN, YOLOXHead. The other
    arguments as build_detector's (stem_out_channels and head_width are
    JAX's defaults, 64 and 256, in its Trainer)."""
    stem_cls = _stem_class(stem, dropout_rate)
    in_channels = tuple(in_channels)
    model = MemoryEventDetector(
        Darknet(stem_cls, input_channels,
                stem_out_channels=stem_out_channels,
                out_channels=in_channels, act=act),
        MemoryModel(cell_type, hidden_dims=in_channels, act="relu"),
        YOLOPAFPN(depth=depth, in_channels=in_channels, act=act),
        YOLOXHead(num_classes, in_channels, strides=strides,
                  width=head_width, act=act))
    init_parameters_(model, generator or torch.Generator().manual_seed(0))
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


__all__ = ["EventDetector", "MemoryEventDetector", "build_detector",
           "build_memory_detector", "detector_loss", "eval_decode",
           "init_parameters_", "rollout_memory_detector"]
