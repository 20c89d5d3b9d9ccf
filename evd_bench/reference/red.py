"""Plain reference of RED, the Recurrent Event-camera Detector (Perot, de
Tournemire, Nitti, Masci and Sironi, "Learning to Detect Objects with a 1
Megapixel Event Camera", NeurIPS 2020, arXiv:2009.13436), as functions of
a flat parameter dict, NCHW inside, in f32:

- an SE-ResNet backbone: a 7x7/2 conv from the input's channels to 32,
  BatchNorm and ReLU, then three squeeze-excitation bottlenecks, 32 → 64,
  64 → 64 and 64 → 128, each at stride 2 (stride 16 in all); a bottleneck
  is three 3x3 conv-BN stages (ReLU after the first two, the stride on the
  second), a squeeze-excitation gate sigmoid(W_up relu(W_down mean(y)))
  at a quarter of the width, and a 1x1/s conv-BN shortcut added to the
  gated output;
- five stacked ConvLSTMs, 256 wide, each halving the map: gates
  [i, f, g, o] = W_x * x + b_x + W_h * h + b_h (3x3 convs, W_x at stride 2),
  c' = sigmoid(f) c + sigmoid(i) tanh(g), h' = sigmoid(o) tanh(c'); level
  k's h' is level k + 1's input and the head's k-th map;
- the SSD head: a 3x3 conv a level for the class logits (boxes x (classes
  + background)) and one for the box regressions (boxes x 4), 6, 6, 6, 4
  and 4 boxes a location, flattened per level in (y, x, box) order.

The memory (the five (h, c) pairs, NHWC) is what a stream carries from one
window to the next; `Net(params, m)(memory, x)` takes the memory before a
window and the window's NHWC volume and returns (the memory after it,
(cls_logits, bbox_pred)); memory None is a fresh stream (zeros).

The priors are the SSD's (min sizes 10, 62, 114, 166, 218 and max sizes
62 ... 270 scaled by height / 256, aspect ratios [2, 3] on the first three
levels and [2] on the last two, centre form, relative, clipped to [0, 1]);
the decode is the variance coding (centre variance 0.1, size variance 0.2)
to pixels, the class scores a softmax without the background, a box's
confidence its largest score and its class scores over that confidence.
`post.postprocess` then takes the top candidates by confidence and runs
greedy NMS, one decision a candidate.

Departures from the paper, which the served model makes too: the input is
the TAF K = 8 volume (16 channels) of FRLW-EvD, not the paper's own event
representation, at the 512x640 geometry that FRLW-EvD scales the 1 Mpx
sensor to (generate_taf.py:216-219); the widths are those of FRLW-EvD's
RED (models/red.py there). Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from evd_bench.reference import post

BN_EPS = 1e-5
HIDDEN = 256
LEVELS = 5
BOXES = (6, 6, 6, 4, 4)
BOTTLENECKS = (("layer1", 32, 64), ("layer2", 64, 64), ("layer3", 64, 128))
CENTER_VARIANCE = 0.1
SIZE_VARIANCE = 0.2
MIN_SIZES = (10, 62, 114, 166, 218)
MAX_SIZES = (62, 114, 166, 218, 270)
ASPECT_RATIOS = ((2, 3), (2, 3), (2, 3), (2,), (2,))


def conv(x, w, bias=None, stride=1, padding=0):
    return F.conv2d(x, w, bias, stride, padding)


def pyramid_shapes(height: int, width: int):
    """(h, w) of the five memory levels: the backbone's stride 16 (ceil),
    then each ConvLSTM halves (ceil)."""
    h, w = -(-height // 16), -(-width // 16)
    out = []
    for _ in range(LEVELS):
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out


def zero_memory(n: int, height: int, width: int, device=None,
                dtype=torch.float32):
    """Fresh memory of n streams for an (height, width) input: (h, c)
    zeros, NHWC, a level each."""
    return tuple((torch.zeros(n, fy, fx, HIDDEN, device=device, dtype=dtype),
                  torch.zeros(n, fy, fx, HIDDEN, device=device, dtype=dtype))
                 for fy, fx in pyramid_shapes(height, width))


class Net:
    """RED of config `m` over the parameter dict `p`; `conv_fn` runs every
    convolution (the control rounds its operands)."""

    def __init__(self, p: dict, m: dict, conv_fn=conv):
        self.p, self.m, self.conv = p, m, conv_fn

    def bn(self, x, name):
        p = self.p
        scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"]
                                                 + BN_EPS)
        shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def conv_bn(self, x, name, stride=1):
        w = self.p[f"{name}_conv.weight"]
        return self.bn(self.conv(x, w, None, stride, (w.shape[-1] - 1) // 2),
                       f"{name}_bn")

    def bottleneck(self, x, name):
        y = F.relu(self.conv_bn(x, f"{name}.c1"))
        y = F.relu(self.conv_bn(y, f"{name}.c2", 2))
        y = self.conv_bn(y, f"{name}.c3")
        se = y.mean(dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.conv(
            F.relu(self.conv(se, self.p[f"{name}.conv_down.weight"])),
            self.p[f"{name}.conv_up.weight"]))
        return se * y + self.conv_bn(x, f"{name}.down", 2)

    def backbone(self, x):
        x = F.relu(self.bn(self.conv(x, self.p["backbone.conv1.weight"],
                                     None, 2, 3), "backbone.bn1"))
        for name, _, _ in BOTTLENECKS:
            x = self.bottleneck(x, f"backbone.{name}")
        return x

    def lstm(self, k, h, c, x):
        p, s = self.p, f"memory.lstms_{k}"
        gates = (self.conv(x, p[f"{s}.input_conv.weight"],
                           p[f"{s}.input_conv.bias"], 2, 1)
                 + self.conv(h, p[f"{s}.rnn_conv.weight"],
                             p[f"{s}.rnn_conv.bias"], 1, 1))
        i, f, g, o = gates.chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def head(self, maps):
        p, cls, reg = self.p, [], []
        for k, x in enumerate(maps):
            n = x.shape[0]
            c = self.conv(x, p[f"predictor.cls_{k}.weight"],
                          p[f"predictor.cls_{k}.bias"], 1, 1)
            r = self.conv(x, p[f"predictor.reg_{k}.weight"],
                          p[f"predictor.reg_{k}.bias"], 1, 1)
            cls.append(c.permute(0, 2, 3, 1).reshape(
                n, -1, self.m["num_classes"] + 1))
            reg.append(r.permute(0, 2, 3, 1).reshape(n, -1, 4))
        return torch.cat(cls, 1), torch.cat(reg, 1)

    def __call__(self, memory, vol_nhwc):
        x = vol_nhwc.permute(0, 3, 1, 2).float()
        if memory is None:
            memory = zero_memory(x.shape[0], x.shape[2], x.shape[3],
                                 x.device)
        x = self.backbone(x)
        new, maps = [], []
        for k, (h, c) in enumerate(memory):
            h, c = self.lstm(k, h.permute(0, 3, 1, 2).float(),
                             c.permute(0, 3, 1, 2).float(), x)
            new.append((h.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)))
            maps.append(h)
            x = h
        return tuple(new), self.head(maps)


def param_spec(m: dict):
    """[(name, shape, kind)] of every state_dict entry of RED of config
    `m`, in a fixed order; kind is what `weights.make_params` draws."""
    spec = []

    def conv_bn(name, cin, cout, k):
        spec.append((f"{name}_conv.weight", (cout, cin, k, k), "conv"))
        bn(f"{name}_bn", cout)

    def bn(name, c):
        for s, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                        ("running_mean", "bn_mean"),
                        ("running_var", "bn_var")):
            spec.append((f"{name}.{s}", (c,), kind))
        spec.append((f"{name}.num_batches_tracked", (), "bn_count"))

    spec.append(("backbone.conv1.weight", (32, m["input_channels"], 7, 7),
                 "conv"))
    bn("backbone.bn1", 32)
    for name, cin, planes in BOTTLENECKS:
        s = f"backbone.{name}"
        conv_bn(f"{s}.c1", cin, planes, 3)
        conv_bn(f"{s}.c2", planes, planes, 3)
        conv_bn(f"{s}.c3", planes, planes, 3)
        conv_bn(f"{s}.down", cin, planes, 1)
        spec += [(f"{s}.conv_down.weight", (planes // 4, planes, 1, 1),
                  "conv"),
                 (f"{s}.conv_up.weight", (planes, planes // 4, 1, 1),
                  "conv")]
    cin = BOTTLENECKS[-1][2]
    for k in range(LEVELS):
        s = f"memory.lstms_{k}"
        spec += [(f"{s}.input_conv.weight", (4 * HIDDEN, cin, 3, 3), "conv"),
                 (f"{s}.input_conv.bias", (4 * HIDDEN,), "zero"),
                 (f"{s}.rnn_conv.weight", (4 * HIDDEN, HIDDEN, 3, 3), "conv"),
                 (f"{s}.rnn_conv.bias", (4 * HIDDEN,), "zero")]
        cin = HIDDEN
    ncls = m["num_classes"] + 1
    for k, boxes in enumerate(BOXES):
        spec += [(f"predictor.cls_{k}.weight", (boxes * ncls, HIDDEN, 3, 3),
                  "conv"),
                 (f"predictor.cls_{k}.bias", (boxes * ncls,), "zero"),
                 (f"predictor.reg_{k}.weight", (boxes * 4, HIDDEN, 3, 3),
                  "conv"),
                 (f"predictor.reg_{k}.bias", (boxes * 4,), "zero")]
    return spec


def priors(height: int, width: int, device=None) -> torch.Tensor:
    """The SSD priors (P, 4) [cx, cy, w, h], relative, f32, clipped to
    [0, 1], in the head's (level, y, x, box) order; the arithmetic in
    double, rounded to f32 once."""
    scale = height / 256
    rows = []
    for k, (fy, fx) in enumerate(pyramid_shapes(height, width)):
        small = MIN_SIZES[k] * scale
        large = math.sqrt(small * (MAX_SIZES[k] * scale))
        for i in range(fy):
            for j in range(fx):
                cx, cy = (j + 0.5) / fx, (i + 0.5) / fy
                rows.append([cx, cy, small / width, small / height])
                rows.append([cx, cy, large / width, large / height])
                for ratio in ASPECT_RATIOS[k]:
                    r = math.sqrt(ratio)
                    w, h = small / width, small / height
                    rows.append([cx, cy, w * r, h / r])
                    rows.append([cx, cy, w / r, h * r])
    return torch.tensor(rows, dtype=torch.float32,
                        device=device).clamp(0.0, 1.0)


def decode(cls_logits, bbox_pred, prior, height: int, width: int,
           dtype=torch.float32):
    """→ (N, P, 5 + C) rows [cx, cy, w, h, conf, scores / conf] in pixels,
    computed in `dtype` (the control one step below the stated one)."""
    cls_logits, loc, prior = (t.to(dtype) for t in (cls_logits, bbox_pred,
                                                     prior))
    scores = torch.softmax(cls_logits, dim=2)[..., 1:]
    boxes = torch.cat([
        loc[..., :2] * CENTER_VARIANCE * prior[None, :, 2:]
        + prior[None, :, :2],
        torch.exp(loc[..., 2:] * SIZE_VARIANCE) * prior[None, :, 2:]], -1)
    boxes = boxes * torch.tensor([width, height, width, height],
                                 dtype=dtype, device=boxes.device)
    conf = scores.max(-1, keepdim=True).values
    return torch.cat([boxes, conf, scores / torch.clamp(conf, min=1e-12)],
                     -1)


def detections(outs, post_cfg: dict, height: int, width: int,
               dtype=torch.float32):
    """decode, then `post.postprocess` with the config's "post" settings:
    dets (N, K, 6) and keep (N, K)."""
    cls_logits, bbox_pred = outs
    prior = priors(height, width, cls_logits.device)
    return post.postprocess(decode(cls_logits, bbox_pred, prior, height,
                                   width, dtype),
                            post_cfg["conf"], post_cfg["nms"],
                            post_cfg["max_detections"])
