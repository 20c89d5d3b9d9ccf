"""The system under test: the serving path of frlw_evd_tpu_torch, built
from a configuration file.

This is the one module of the harness that imports the program. It takes
from it the model, the pipeline factory, the fresh state and the kernels'
launch counters, and nothing of the yardstick.
"""

from __future__ import annotations

import importlib

import torch

from .system import System


def build(cfg: dict, params: dict, batch: int, device) -> System:
    """The program's serving path for configuration `cfg`, its detector
    loaded with the f32 `params` and cast by the pipeline to cfg's dtype."""
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.models.detector import build_detector

    m = dict(cfg["model"])
    m["in_channels"] = tuple(m["in_channels"])
    m["strides"] = tuple(m["strides"])
    model = build_detector(m.pop("num_classes"), **m).to(device)
    model.load_state_dict(params, strict=True)
    factory = getattr(pipeline, cfg["pipeline"]["factory"])
    run_step = factory(model, **cfg["pipeline"]["args"], device=device,
                       dtype=getattr(torch, cfg["dtype"]))
    sensor = tuple(cfg["sensor_hw"])
    p64 = cfg["layout"] == "p64_folded"
    return System(run_step, run_step.stages, model,
                  lambda: pipeline.new_state(batch, sensor, p64=p64,
                                             device=device))


def launch_counts(kernels: dict) -> dict:
    """The launch counter of each kernel wrapper in `kernels` ({name:
    "module:function"}); 0 where the program has no such counter."""
    out = {}
    for name, path in kernels.items():
        module, fn = path.split(":")
        try:
            out[name] = getattr(getattr(importlib.import_module(module), fn),
                                "launches", 0)
        except (ImportError, AttributeError):
            out[name] = 0
    return out
