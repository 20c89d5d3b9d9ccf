"""A tiny cell of the red_gen4 configuration on the CPU, start to end: a
sound run reads correct, and the RED control, a memory left unchanged, a
memory reset every step and the deepest level's memory reset every step
read not correct; the per-layer readers of the memory's span and
counters."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from evd_bench import harness, program
from evd_bench.reference import red_control

CPU = torch.device("cpu")
SENSOR = (64, 96)
# the f32 model on the program's bf16 volume reads 2e-4 / 3e-4
LIMITS = {"state_gap": 0.004, "volume_gap": 0.004, "memory_gap": 0.005,
          "head_gap": 0.005, "post_mismatch": 0, "kernel_shortfall": 0}


def write_tiny_red(root: Path) -> harness.Bench:
    """red_gen4 at 64x96 with 4 streams of 256 event slots, in f32, and a
    cell over it, under `root`; the real cell's per-layer metrics."""
    for kind in ("configs", "cells"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((harness.HERE / "configs" / "red_gen4.json")
                     .read_text())
    cfg.update(name="tiny_red", sensor_hw=list(SENSOR),
               input_hw=list(SENSOR), events_per_window=256,
               dtype="float32")
    cfg["pipeline"]["args"].update(sensor_hw=list(SENSOR),
                                   input_hw=list(SENSOR))
    (root / "configs" / "tiny_red.json").write_text(json.dumps(cfg))
    cell = json.loads((harness.HERE / "cells" / "red_gen4_serve_b128.json")
                      .read_text())
    cell.update(name="tiny_red_cell", config="tiny_red", batch=4,
                warmup_steps=1, profile_steps=2)
    cell["check"].update(steps_from=2, steps_to=6, steps=2, streams=2,
                         block=2, limits=dict(LIMITS))
    (root / "cells" / "tiny_red_cell.json").write_text(json.dumps(cell))
    spec = json.loads(harness.SPEC.read_text())
    spec["workloads"] = [{"name": "tiny_red_cell", "config": "tiny_red",
                          "traffic": "events_mixed", "chips": 1,
                          "why": "t"}]
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if "red_gen4_serve_b128" in m["workloads"]]
    for m in spec["per_layer"] + spec["end_to_end"]:
        m["workloads"] = ["tiny_red_cell"]
    return harness.Bench(spec, roots=(root, harness.HERE))


@pytest.fixture(scope="module")
def tiny_red(tmp_path_factory):
    torch.set_num_threads(2)
    return write_tiny_red(tmp_path_factory.mktemp("tiny_red"))


def run(bench, trace=False, build=None, seed=2 ** 31 + 11):
    return harness.run(bench, "tiny_red_cell", seed, 0.3, trace, CPU,
                       time.perf_counter(), build=build)


def test_sound_run_is_correct(tiny_red):
    result, rows = run(tiny_red)
    assert result["correct"], rows
    assert set(result["metrics"]) == {"windows_per_s", "window_p95_ms",
                                      "setup_s"}
    readings = {k: v for k, v, _ in rows}
    assert readings["memory_gap"] > 0 and readings["head_gap"] > 0


def test_traced_run_reads_the_memory(tiny_red):
    result, rows = run(tiny_red, trace=True)
    assert result["correct"], rows
    got = result["metrics"]
    assert got["memory_carried_share"]["value"] == 100.0
    for name in ("nms_rounds", "host_syncs", "idle_share"):
        assert name in got
    # no CUDA events on the CPU, so no device ms
    assert "memory_ms" not in got and "forward_ms" not in got


def test_control_is_not_correct(tiny_red):
    result, rows = run(tiny_red, build=red_control.build)
    failed = {k for k, v, lim in rows if not v <= lim}
    assert not result["correct"]
    assert {"state_gap", "volume_gap", "memory_gap", "head_gap",
            "post_mismatch"} <= failed


def memory_fault(kind):
    """program.build with the memory handled wrongly in detect: left as
    it was before the step ("unchanged"), dropped after every step, so
    that each step starts from zero ("reset"), or the deepest level's
    alone zeroed after every step ("deepest")."""
    def build(cfg, params, batch, device):
        s = program.build(cfg, params, batch, device)
        detect = s.stages["detect"]

        def bad_detect(inp):
            before = inp.state.memory
            out = detect(inp)
            if kind == "deepest":
                *kept, last = inp.state.memory
                inp.state.memory = (*kept, tuple(map(torch.zeros_like, last)))
            else:
                inp.state.memory = before if kind == "unchanged" else None
            return out

        stages = dict(s.stages, detect=bad_detect)

        def run_step(state, xytp, n_valid):
            state, inp = stages["encode_transform"](state, xytp, n_valid)
            return state, bad_detect(inp)

        run_step.stages = stages
        return s._replace(run_step=run_step, stages=stages)
    return build


@pytest.mark.parametrize("kind", ["unchanged", "reset", "deepest"])
def test_memory_fault_is_not_correct(tiny_red, kind):
    result, rows = run(tiny_red, build=memory_fault(kind))
    readings = {k: v for k, v, _ in rows}
    assert not result["correct"], rows
    assert readings["memory_gap"] > 0.1
