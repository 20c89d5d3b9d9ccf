"""FLOPs of one window through the AED, counted on the reference model at
the cell's shapes (torch's FlopCounterMode on the meta device: the
convolutions at 2 FLOPs a multiply-add, grouped ones at their real size;
nothing elementwise), never from what the program runs. Only a traced run
counts them, after its window."""

from __future__ import annotations

import torch

from evd_bench.reference import aed


def flops_per_window(cfg: dict) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    m = cfg["model"]
    params = {name: torch.empty(shape, device="meta")
              for name, shape, _ in aed.param_spec(m)}
    x = torch.empty(1, *cfg["input_hw"], m["input_channels"], device="meta")
    with FlopCounterMode(display=False) as counter:
        aed.Net(params, m)(x)
    return counter.get_total_flops()
