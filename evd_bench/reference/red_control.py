"""The control of a served RED (configuration family "red"): the plain
reference put in the program's place, each stage computed one step below
the precision the configuration states (`control.PRECISION_BELOW`): the
f32 queue kept in bf16, the bf16 volume and the bf16 detector's
convolution operands rounded to fp8 (e4m3, one scale a tensor), the f32
memory carried in bf16 from window to window, the f32 decode and scores
in bf16. The program stores its memory in f32 and computes the
ConvLSTMs' convolutions in TF32 (the configuration's
"precision_detail"); the step below is taken from the stored precision,
and bf16 keeps fewer mantissa bits (8) than TF32's products (11).

It has the program's interface (run_step with its two stages, a detector
module called as model(memory, volume), a fresh state), so the harness
drives and judges it as it does the program; its readings are taken
through `harness.run(..., build=red_control.build)`. A sound comparison
reads it as not correct.
"""

from __future__ import annotations

import torch

from evd_bench.reference import control, red, taf
from evd_bench.system import System


class State:
    """B streams' queue (b, H, W, K, 2) and memory (None: fresh)."""

    def __init__(self, queue, memory=None):
        self.queue, self.memory = queue, memory


class Detector(torch.nn.Module):
    """The reference RED as a module, every convolution's operands rounded
    to `conv_dtype` and the memory it returns to `memory_dtype`."""

    def __init__(self, params: dict, cfg: dict, conv_dtype: str,
                 memory_dtype: str):
        super().__init__()
        self.memory_dtype = getattr(torch, memory_dtype)

        def conv(x, w, bias=None, stride=1, padding=0):
            return red.conv(control.round_to(x, conv_dtype),
                            control.round_to(w, conv_dtype), bias, stride,
                            padding)
        self.net = red.Net(params, cfg["model"], conv)

    def forward(self, memory, vol):
        memory, outs = self.net(memory, vol)
        return tuple((h.to(self.memory_dtype), c.to(self.memory_dtype))
                     for h, c in memory), outs


def build(cfg: dict, params: dict, batch: int, device) -> System:
    """The control for configuration `cfg` with the f32 `params`."""
    below = {k: control.PRECISION_BELOW[v]
             for k, v in cfg["precision"].items()}
    K, (H, W) = cfg["K"], cfg["sensor_hw"]
    h, w = cfg["input_hw"]
    model = Detector(params, cfg, below["detector"], below["memory"])

    def new_state():
        return State(taf.new_queue(batch, H, W, K, device=device,
                                   dtype=getattr(torch, below["queue"])))

    def encode_transform(state, xytp, n_valid):
        state.queue = taf.queue_step(state.queue, xytp, n_valid)
        vol = control.round_to(taf.volume(state.queue), below["volume"])
        return state, (taf.resize(vol, (H, W), (h, w)), state)

    @torch.inference_mode()
    def detect(inp):
        vol, state = inp
        memory = state.memory
        if memory is None:
            memory = red.zero_memory(vol.shape[0], h, w, vol.device,
                                     model.memory_dtype)
        state.memory, outs = model(memory, vol)
        return red.detections(outs, cfg["post"], h, w,
                              getattr(torch, below["post"]))

    def run_step(state, xytp, n_valid):
        state, inp = encode_transform(state, xytp, n_valid)
        return state, detect(inp)

    stages = {"encode_transform": encode_transform, "detect": detect}
    run_step.stages = stages
    return System(run_step, stages, model, new_state)
