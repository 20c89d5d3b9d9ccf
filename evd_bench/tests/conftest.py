"""Tiny cells for the harness's CPU tests: both configurations at widths
16 and 32x64 inputs, 4 streams of 256 event slots, written as files under
a temporary root that the harness searches before evd_bench/."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from evd_bench import harness  # noqa: E402

TINY = {"tiny_gen1": ("aed_gen1", (30, 60), (32, 64)),
        "tiny_gen4": ("aed_gen4", (32, 64), (32, 64))}
LIMITS = {"state_gap": 0.004, "volume_gap": 0.004, "head_gap": 0.01,
          "post_mismatch": 0, "kernel_shortfall": 0}


def write_tiny(root: Path, dtype: str = "float32") -> dict:
    """Tiny configs and cells under root; returns a BENCHMARK.json-like
    spec with those cells in place of the real ones."""
    for kind in ("configs", "cells"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    workloads = []
    for name, (src, sensor, inp) in TINY.items():
        cfg = json.loads((harness.HERE / "configs" / f"{src}.json")
                         .read_text())
        cfg.update(name=name, sensor_hw=list(sensor), input_hw=list(inp),
                   events_per_window=256, dtype=dtype)
        cfg["model"].update(in_channels=[16, 16, 16], stem_out_channels=8,
                            head_width=16)
        args = cfg["pipeline"]["args"]
        args["sensor_hw"] = list(sensor)
        if "input_hw" in args:
            args["input_hw"] = list(inp)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = json.loads((harness.HERE / "cells" / "gen1_serve_b128.json")
                          .read_text())
        cell.update(name=f"{name}_cell", config=name, batch=4,
                    warmup_steps=1, profile_steps=2)
        cell["check"] = dict(name="aed_serve", steps_from=2, steps_to=5,
                             steps=2, streams=2, block=2,
                             limits=dict(LIMITS))
        (root / "cells" / f"{name}_cell.json").write_text(json.dumps(cell))
        workloads.append({"name": f"{name}_cell", "config": name,
                          "traffic": "events_mixed", "chips": 1, "why": "t"})
    spec = json.loads(harness.SPEC.read_text())
    spec["workloads"] = workloads
    cells = [w["name"] for w in workloads]
    for m in spec["per_layer"] + spec["end_to_end"]:
        m["workloads"] = cells
    return spec


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    return harness.Bench(write_tiny(root), roots=(root, harness.HERE))
