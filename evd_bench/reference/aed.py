"""Plain reference of the AED detector: BFM stem, Darknet-21, YOLOPAFPN and
the YOLOX head, as functions of a flat parameter dict, NCHW, in f32.

The parameter names and shapes (`param_spec`) are those of the serving
model's state_dict, so one set of weights made from the seed loads into
both. Each conv runs through `conv`, which the control replaces by one
that rounds its operands to a lower precision.

Written from the AED of HarmoniaLeo/FRLW-EvD (core/exp.py, taf_bfm) with
one departure that the served model makes too: the BFM channel mixer's
activation is the network's (silu), where the upstream uses GELU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
DARKNET_BLOCKS = (1, 2, 2, 1)


def conv(x, w, bias=None, stride=1, padding=0, groups=1):
    return F.conv2d(x, w, bias, stride, padding, 1, groups)


class Net:
    """The AED of config `m` (the config file's "model" object) over the
    parameter dict `p`; `conv_fn` runs every convolution."""

    def __init__(self, p: dict, m: dict, conv_fn=conv):
        self.p, self.m, self.conv = p, m, conv_fn

    # blocks -------------------------------------------------------------
    def bn(self, x, name):
        p = self.p
        scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"]
                                                 + BN_EPS)
        shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def base(self, x, name, stride=1):
        w = self.p[f"{name}.conv.weight"]
        k = w.shape[-1]
        y = self.conv(x, w, None, stride, (k - 1) // 2)
        return F.silu(self.bn(y, f"{name}.bn"))

    def res(self, x, name):
        return x + self.base(self.base(x, f"{name}.layer1"), f"{name}.layer2")

    def csp(self, x, name, n):
        x1 = self.base(x, f"{name}.conv1")
        for i in range(n):       # bottlenecks without shortcut in the neck
            x1 = self.base(self.base(x1, f"{name}.m_{i}.conv1"),
                           f"{name}.m_{i}.conv2")
        return self.base(torch.cat([x1, self.base(x, f"{name}.conv2")], 1),
                         f"{name}.conv3")

    # stem ---------------------------------------------------------------
    def wn_conv(self, x, name, groups):
        v = self.p[f"{name}.weight_v"]
        g = self.p[f"{name}.weight_g"]
        w = v * (g / torch.sqrt((v * v).sum(dim=(1, 2, 3)) + 1e-12)).view(
            -1, 1, 1, 1)
        return self.conv(x, w, self.p[f"{name}.bias"], 1, 0, groups)

    def bfm(self, x, name="backbone.stem"):
        """(N, 2K, H, W) → (N, stem_out, H/2, W/2): the grouped weight-norm
        1x1 cascade, the first `embed` channels of each level, the MLP
        mixer with its residual, then 2x2 patchify [tl, bl, tr, br] and a
        3x3 conv."""
        p, embed = self.p, 4
        tc = x.shape[1] // 2
        h, outs = x, []
        for i in range(int(math.log2(tc))):
            h = F.relu(self.wn_conv(h, f"{name}.convs_{i}", tc // 2))
            outs.append(h[:, :embed])
            tc //= 2
        h = torch.cat(outs, 1)
        up = F.silu(self.conv(h, p[f"{name}.trans_up.weight"],
                              p[f"{name}.trans_up.bias"]))
        h = h + self.conv(up, p[f"{name}.trans_down.weight"],
                          p[f"{name}.trans_down.bias"])
        h = torch.cat([h[:, :, 0::2, 0::2], h[:, :, 1::2, 0::2],
                       h[:, :, 0::2, 1::2], h[:, :, 1::2, 1::2]], 1)
        return self.base(h, f"{name}.conv")

    # network ------------------------------------------------------------
    def backbone(self, x):
        x = self.bfm(x)
        feats = []
        for g, name in enumerate(("dark2", "dark3", "dark4", "dark5_group")):
            x = self.base(x, f"backbone.{name}.conv", stride=2)
            for i in range(DARKNET_BLOCKS[g]):
                x = self.res(x, f"backbone.{name}.res_{i}")
            feats.append(x)
        s = "backbone.dark5_spp"
        x = self.base(self.base(x, f"{s}.conv1"), f"{s}.conv2")
        x = self.base(x, f"{s}.spp.conv1")
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        x = torch.cat([x] + pools, 1)
        x = self.base(x, f"{s}.spp.conv2")
        x = self.base(self.base(x, f"{s}.conv3"), f"{s}.conv4")
        return feats[1], feats[2], x

    def neck(self, d3, d4, d5):
        n = round(3 * self.m["depth"])
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        fpn0 = self.base(d5, "neck.lateral_conv0")
        f0 = self.csp(torch.cat([up(fpn0), d4], 1), "neck.C3_p4", n)
        fpn1 = self.base(f0, "neck.reduce_conv1")
        pan2 = self.csp(torch.cat([up(fpn1), d3], 1), "neck.C3_p3", n)
        pan1 = self.csp(torch.cat([self.base(pan2, "neck.bu_conv2", 2), fpn1],
                                  1), "neck.C3_n3", n)
        pan0 = self.csp(torch.cat([self.base(pan1, "neck.bu_conv1", 2), fpn0],
                                  1), "neck.C3_n4", n)
        return pan2, pan1, pan0

    def head(self, feats):
        p, outs = self.p, []
        for k, x in enumerate(feats):
            x = self.base(x, f"head.stems_{k}")
            cls = self.base(self.base(x, f"head.cls_convs_{k}_0"),
                            f"head.cls_convs_{k}_1")
            reg = self.base(self.base(x, f"head.reg_convs_{k}_0"),
                            f"head.reg_convs_{k}_1")
            pred = lambda f, n: self.conv(f, p[f"head.{n}_preds_{k}.weight"],
                                          p[f"head.{n}_preds_{k}.bias"])
            out = torch.cat([pred(reg, "reg"), pred(reg, "obj"),
                             pred(cls, "cls")], 1)
            outs.append(out.permute(0, 2, 3, 1))
        return outs

    def __call__(self, vol_nhwc):
        """(N, H, W, 2K) volume → per level (N, h, w, 4 + 1 + classes),
        [reg, obj, cls]."""
        x = vol_nhwc.permute(0, 3, 1, 2).float()
        return self.head(self.neck(*self.backbone(x)))


def param_spec(m: dict):
    """[(name, shape, kind)] of every state_dict entry of the AED of config
    `m`, in a fixed order. kind is what `weights.make_params` draws:
    conv, wn_v, wn_g, zero, cls_bias, obj_bias, bn_w, bn_b, bn_mean,
    bn_var, bn_count."""
    spec = []

    def base(name, cin, cout, k):
        spec.append((f"{name}.conv.weight", (cout, cin, k, k), "conv"))
        for s, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                        ("running_mean", "bn_mean"),
                        ("running_var", "bn_var")):
            spec.append((f"{name}.bn.{s}", (cout,), kind))
        spec.append((f"{name}.bn.num_batches_tracked", (), "bn_count"))

    c_in, embed = m["input_channels"], 4
    s = "backbone.stem"
    tc, cin = c_in // 2, c_in
    levels = int(math.log2(tc))
    for i in range(levels):
        out = embed * tc // 2
        spec += [(f"{s}.convs_{i}.weight_v", (out, cin // (tc // 2), 1, 1),
                  "wn_v"), (f"{s}.convs_{i}.weight_g", (out,), "wn_g"),
                 (f"{s}.convs_{i}.bias", (out,), "zero")]
        cin, tc = out, tc // 2
    mixer = embed * levels
    spec += [(f"{s}.trans_up.weight", (4 * mixer, mixer, 1, 1), "conv"),
             (f"{s}.trans_up.bias", (4 * mixer,), "zero"),
             (f"{s}.trans_down.weight", (mixer, 4 * mixer, 1, 1), "conv"),
             (f"{s}.trans_down.bias", (mixer,), "zero")]
    base(f"{s}.conv", 4 * mixer, m["stem_out_channels"], 3)

    c3, c4, c5 = m["in_channels"]
    b0 = m["stem_out_channels"]
    for g, (name, ci, co) in enumerate((("dark2", b0, 2 * b0),
                                        ("dark3", 2 * b0, c3),
                                        ("dark4", c3, c4),
                                        ("dark5_group", c4, c5))):
        base(f"backbone.{name}.conv", ci, co, 3)
        for i in range(DARKNET_BLOCKS[g]):
            base(f"backbone.{name}.res_{i}.layer1", co, co // 2, 1)
            base(f"backbone.{name}.res_{i}.layer2", co // 2, co, 3)
    s = "backbone.dark5_spp"
    base(f"{s}.conv1", c5, c5, 1)
    base(f"{s}.conv2", c5, c5, 3)
    base(f"{s}.spp.conv1", c5, c5 // 2, 1)
    base(f"{s}.spp.conv2", c5 // 2 * 4, c5, 1)
    base(f"{s}.conv3", c5, c5, 3)
    base(f"{s}.conv4", c5, c5, 1)

    n = round(3 * m["depth"])

    def csp(name, cin, cout):
        hid = cout // 2
        base(f"{name}.conv1", cin, hid, 1)
        base(f"{name}.conv2", cin, hid, 1)
        for i in range(n):
            base(f"{name}.m_{i}.conv1", hid, hid, 1)
            base(f"{name}.m_{i}.conv2", hid, hid, 3)
        base(f"{name}.conv3", 2 * hid, cout, 1)

    base("neck.lateral_conv0", c5, c4, 1)
    csp("neck.C3_p4", 2 * c4, c4)
    base("neck.reduce_conv1", c4, c3, 1)
    csp("neck.C3_p3", 2 * c3, c3)
    base("neck.bu_conv2", c3, c3, 3)
    csp("neck.C3_n3", 2 * c3, c4)
    base("neck.bu_conv1", c4, c4, 3)
    csp("neck.C3_n4", 2 * c4, c5)

    w, ncls = m["head_width"], m["num_classes"]
    for k, cin in enumerate(m["in_channels"]):
        base(f"head.stems_{k}", cin, w, 1)
        for branch in ("cls", "reg"):
            for layer in (0, 1):
                base(f"head.{branch}_convs_{k}_{layer}", w, w, 3)
        for branch, cout, bias in (("cls", ncls, "cls_bias"),
                                   ("reg", 4, "zero"), ("obj", 1, "obj_bias")):
            spec += [(f"head.{branch}_preds_{k}.weight", (cout, w, 1, 1),
                      "conv"), (f"head.{branch}_preds_{k}.bias", (cout,),
                                bias)]
    return spec
