"""FLOPs of one window through RED, counted on the reference model at the
cell's shapes (torch's FlopCounterMode on the meta device: the
convolutions at 2 FLOPs a multiply-add, the ConvLSTMs' on a carried
memory; nothing elementwise), never from what the program runs. Only a
traced run counts them, after its window."""

from __future__ import annotations

import torch

from evd_bench.reference import red


def flops_per_window(cfg: dict) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    m, (h, w) = cfg["model"], cfg["input_hw"]
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _ in red.param_spec(m)}
    x = torch.empty(1, h, w, m["input_channels"], device="meta")
    memory = red.zero_memory(1, h, w, "meta")
    with FlopCounterMode(display=False) as counter:
        red.Net(params, m)(memory, x)
    return counter.get_total_flops()
