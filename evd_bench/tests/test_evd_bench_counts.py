"""The yardstick's counts by hand at tiny shapes: the kernels' bytes and
operations, one convolution's FLOPs, and the window tail taken over all
windows."""

from __future__ import annotations

import json
import statistics
import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from evd_bench import harness, peaks, stats
from evd_bench.drivers import serve_closed
from evd_bench.reference import aed
from evd_bench.roofline import b1, b2, b3, b4, bound_s
from evd_bench.roofline.aed import flops_per_window
from evd_bench.system import System


def test_b1_bytes_by_hand():
    # 5 events of x, y, t, p in f32; n_valid and any_ev of 2 streams; the
    # count and t-sum planes of 2 streams x 2 x 3 pixels x 2 polarities
    assert b1.work(5, 2, 2, 3)["bytes"] == 5 * 16 + 2 * 4 + 2 * 24 * 4 + 2 * 4


def test_b2_b3_bytes_by_hand():
    # queue 2 x 2 x 3 pixels x 16 slots f32, read and written; planes
    # read; any_ev; the bf16 volume written
    want = 2 * 192 * 4 + 2 * 24 * 4 + 2 * 4 + 192 * 2
    assert b2.work(2, 2, 3, 8)["bytes"] == want
    assert b3.work(2, 2, 3, 8)["bytes"] == want


def test_b4_work_by_hand():
    w = b4.work(1, 1, 1, 16)
    # 16 -> 16 in 4 groups (64), 16 -> 8 in 2 (64), 8 -> 4 (32), 12 -> 48
    # -> 12 (2 x 576) multiply-adds a pixel
    assert w["bf16_flops"] == 2 * (64 + 64 + 32 + 1152)
    assert w["sfu_ops"] == 2 * 48          # a silu: exp2 and reciprocal
    assert w["bytes"] == 2 * 16 + 2 * 12   # bf16 in, 12 channels out
    assert bound_s(w) == pytest.approx(96 / peaks.SFU_OPS_PER_S)


def test_conv_flops_by_hand():
    x = torch.empty(1, 8, 10, 12, device="meta")
    with FlopCounterMode(display=False) as c:
        aed.conv(x, torch.empty(16, 8, 3, 3, device="meta"), padding=1)
        aed.conv(x, torch.empty(16, 2, 1, 1, device="meta"), groups=4)
    assert c.get_total_flops() == (2 * 16 * 8 * 9 * 120 + 2 * 16 * 2 * 120)


def test_aed_flops_at_the_cells_shapes():
    g1 = json.loads((harness.HERE / "configs" / "aed_gen1.json").read_text())
    g4 = json.loads((harness.HERE / "configs" / "aed_gen4.json").read_text())
    # 4x the pixels at the same widths; the head's class convs differ
    assert 16e9 < flops_per_window(g1) < 17.5e9
    assert flops_per_window(g4) == pytest.approx(4 * flops_per_window(g1),
                                                 rel=0.01)


def test_p95_is_over_all_windows():
    lat = [0.010] * 100
    for i in (3, 5, 7, 9, 11, 13):        # six stalled steps, early on
        lat[i] = 0.100
    assert stats.percentile(lat, 95) == pytest.approx(0.100)
    chunks = [stats.percentile(lat[i:i + 10], 95) for i in range(0, 100, 10)]
    assert statistics.median(chunks) == pytest.approx(0.010)


def test_driver_counts_a_stalled_step_in_the_tail(tiny):
    """serve_closed over a system whose every tenth step stalls: the tail
    is the stall, the rate all windows over all the time."""
    calls = []

    def build(cfg, params, batch, device):
        def run_step(state, xytp, n_valid):
            calls.append(1)
            time.sleep(0.060 if len(calls) % 10 == 0 else 0.002)
            return state, (torch.zeros(batch, 1, 6),
                           torch.zeros(batch, 1, dtype=bool))
        return System(run_step, {}, torch.nn.Identity(),
                      lambda: torch.zeros(1))

    class Recorder:
        def begin(self, step):
            pass

        def end(self, step, dets, keep):
            pass

        def done(self):
            return True

        def close(self):
            pass

    checker = SimpleNamespace(recorder=lambda ctx, system, batch:
                              Recorder())
    cell = tiny.json("cells", "tiny_gen1_cell")
    ctx = SimpleNamespace(
        bench=tiny, name="tiny_gen1_cell", cell=cell,
        cfg=tiny.json("configs", cell["config"]),
        traffic=tiny.json("traffic", cell["traffic"]), seed=5, seconds=0.5,
        trace=False, device=torch.device("cpu"), t0=time.perf_counter(),
        build=build)
    out = serve_closed.run(ctx, checker)
    e2e = out["end_to_end"]
    assert e2e["window_p95_ms"] >= 55.0
    assert statistics.median(out["latencies_s"]) < 0.02
    assert e2e["windows_per_s"] == pytest.approx(
        cell["batch"] * out["steps"] / out["elapsed_s"])
    assert out["elapsed_s"] >= 0.5
