"""The control: the plain reference put in the program's place, each
stage computed one step below the precision the configuration states
(`PRECISION_BELOW`): the f32 queue kept in bf16, the bf16 volume and the
bf16 detector's convolution operands rounded to fp8 (e4m3, one scale a
tensor), the f32 decode and scores in bf16.

It has the program's interface (run_step with its two stages, a detector
module, a fresh state in the program's layout), so the harness drives and
judges it exactly as it does the program. A sound comparison reads it as
not correct.
"""

from __future__ import annotations

import torch

from . import aed, post, taf
from ..system import System

PRECISION_BELOW = {"float64": "float32", "float32": "bfloat16",
                   "bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}
FP8_MAX = 448.0


def round_to(x: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """x rounded to `dtype_name` and back to x's dtype; fp8 with one scale
    for the tensor, its largest magnitude at fp8's largest value."""
    if dtype_name.startswith("float8"):
        scale = x.abs().amax().float().clamp_min(1e-30) / FP8_MAX
        return ((x.float() / scale).to(getattr(torch, dtype_name)).float()
                * scale).to(x.dtype)
    return x.to(getattr(torch, dtype_name)).to(x.dtype)


class Detector(torch.nn.Module):
    """The reference AED as a module, taking the volume in the program's
    layout, every convolution's operands rounded to `conv_dtype`."""

    def __init__(self, params: dict, cfg: dict, conv_dtype: str):
        super().__init__()
        self.cfg = cfg

        def conv(x, w, bias=None, stride=1, padding=0, groups=1):
            return aed.conv(round_to(x, conv_dtype), round_to(w, conv_dtype),
                            bias, stride, padding, groups)
        self.net = aed.Net(params, cfg["model"], conv)

    def forward(self, vol):
        return self.net(taf.from_layout(vol, self.cfg["layout"],
                                        2 * self.cfg["K"]))


def build(cfg: dict, params: dict, batch: int, device) -> System:
    """The control for configuration `cfg` with the f32 `params`."""
    below = {k: PRECISION_BELOW[v] for k, v in cfg["precision"].items()}
    K, (H, W) = cfg["K"], cfg["sensor_hw"]
    layout = cfg["layout"]
    model = Detector(params, cfg, below["detector"])
    strides = cfg["model"]["strides"]

    def new_state():
        q = taf.new_queue(batch, H, W, K, device=device,
                          dtype=getattr(torch, below["queue"]))
        return taf.to_layout(q.reshape(batch, H, W, 2 * K), layout)

    def encode_transform(state, xytp, n_valid):
        q = taf.from_layout(state, layout, 2 * K).reshape(batch, H, W, K, 2)
        q = taf.queue_step(q, xytp, n_valid)
        vol = round_to(taf.volume(q), below["volume"])
        vol = taf.resize(vol, (H, W), cfg["input_hw"])
        return taf.to_layout(q.reshape(batch, H, W, 2 * K), layout), \
            taf.to_layout(vol, layout)

    @torch.inference_mode()
    def detect(vol):
        outs = model(vol)
        return post.detections(outs, cfg["post"], strides,
                               getattr(torch, below["post"]))

    def run_step(state, xytp, n_valid):
        state, vol = encode_transform(state, xytp, n_valid)
        return state, detect(vol)

    stages = {"encode_transform": encode_transform, "detect": detect}
    run_step.stages = stages
    return System(run_step, stages, model, new_state)
