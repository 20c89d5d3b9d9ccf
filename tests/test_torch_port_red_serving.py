"""RED on the port's serving path (pipeline.make_pipeline_recurrent, the
stream state with its memory) against the benchmark's plain reference
(evd_bench/reference/red.py) on the CPU.

Weights: evd_bench.weights.make_params from the reference's param_spec
(the served model's state_dict), so both hold the same numbers. Size
64x96, B = 2, events at 256 slots a stream window. The model serves in
f32 here; the volume is B2's bf16 either way, so the reference reads the
program's own volume and the comparison holds the detector and its
memory alone: over 8 windows the carried memory and the head outputs
agree within relative L2 1e-5 (the same f32 operations in another order:
the two read 1e-7 to 1e-6 apart), and the kept boxes are equal.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models.detector import (RED_IN_CHANNELS,
                                                RED_STRIDES, build_detector)
from frlw_evd_tpu_torch.models.red import REDDetector
from frlw_evd_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from evd_bench import weights  # noqa: E402
from evd_bench.reference import red as ref  # noqa: E402

HW = (64, 96)
B = 2
E = 256
STEPS = 8
TOL = 1e-5
MODEL = {"family": "red", "num_classes": 7, "input_channels": 16,
         "in_channels": list(RED_IN_CHANNELS), "strides": list(RED_STRIDES)}
POST = {"conf": 0.01, "nms": 0.45, "max_detections": 15}


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small ops: pinned to one thread, as the other port files pin
    theirs in the suite's 6-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return weights.make_params(ref.param_spec(MODEL), 0, "cpu")


def served(params):
    model = build_detector(7, family="red", input_channels=16,
                           in_channels=RED_IN_CHANNELS, strides=RED_STRIDES)
    model.load_state_dict(params, strict=True)
    return pipeline.make_pipeline_recurrent(model, HW, HW, device="cpu",
                                            dtype=torch.float32), model


def windows(n=STEPS, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        xy = torch.rand(B, E, 2, generator=gen) * torch.tensor(
            [HW[1], HW[0]], dtype=torch.float32)
        t = torch.sort(torch.rand(B, E, generator=gen), dim=1).values
        p = torch.randint(0, 2, (B, E), generator=gen).float()
        ev = torch.cat([xy.floor(), t[..., None], p[..., None]], -1)
        out.append((ev, torch.randint(E // 4, E + 1, (B,), generator=gen,
                                      dtype=torch.int32)))
    return out


def rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-300))


def flat(memory):
    return torch.cat([t.reshape(-1) for pair in memory for t in pair])


def test_serving_step_matches_reference_over_windows(params):
    """Memory and head outputs within TOL of the reference on its own
    memory, every window; the kept boxes the reference's post keeps on the
    reference's head outputs (within 1e-4: the heads differ in their last
    bits), and bit for bit on the program's own."""
    run_step, model = served(params)
    net = ref.Net(params, MODEL)
    heads = []
    hook = model.register_forward_hook(
        lambda mod, args, out: heads.append(out[1]))
    state = pipeline.new_state(B, HW, device="cpu")
    memory = None
    kept = 0
    try:
        for xytp, n_valid in windows():
            state, inp = run_step.stages["encode_transform"](state, xytp,
                                                             n_valid)
            dets, keep = run_step.stages["detect"](inp)
            with torch.no_grad():
                memory, outs = net(memory, inp.volume.float())
            assert rel(flat(state.memory), flat(memory)) < TOL
            for got, want in zip(heads[-1], outs):
                assert rel(got, want) < TOL
            r_dets, r_keep = ref.detections(outs, POST, *HW)
            assert torch.equal(keep, r_keep)
            torch.testing.assert_close(dets[keep], r_dets[r_keep],
                                       rtol=1e-4, atol=1e-4)
            p_dets, p_keep = ref.detections(heads[-1], POST, *HW)
            assert torch.equal(keep, p_keep)
            assert torch.equal(dets[keep], p_dets[p_keep])
            kept += int(keep.sum())
    finally:
        hook.remove()
    assert kept > 0


def test_bare_queue_starts_from_zero_memory(params):
    run_step, model = served(params)
    seen = []
    hook = model.register_forward_pre_hook(
        lambda mod, args: seen.append(flat(args[0]).abs().max()))
    queue = pipeline.new_state(B, HW, device="cpu")
    (xytp, n_valid), = windows(1)
    try:
        with profiling.recording():
            state, _ = run_step(queue, xytp, n_valid)
            run_step(state, xytp, n_valid)
        records = profiling.span_records()[-40:]
    finally:
        hook.remove()
    assert isinstance(state, pipeline.RecurrentState)
    assert state.queue is queue
    assert float(seen[0]) == 0.0 and float(seen[1]) > 0.0
    counts = [r.counts for r in records if r.name == "serve.forward"]
    assert counts[-2] == {"memory_fresh": B, "memory_carried": 0}
    assert counts[-1] == {"memory_fresh": 0, "memory_carried": B}
    names = {r.name for r in records}
    assert {"serve.backbone", "serve.memory"} <= names
    parent = {r.name: r.parent.name for r in records
              if r.parent is not None}
    assert parent["serve.memory"] == parent["serve.backbone"] == \
        "serve.forward"


def test_run_step_and_stages_carry_the_same_memory(params):
    run_step, _ = served(params)
    a = pipeline.new_state(B, HW, device="cpu")
    b = pipeline.new_state(B, HW, device="cpu")
    for xytp, n_valid in windows(4):
        a, (dets_a, keep_a) = run_step(a, xytp, n_valid)
        b, inp = run_step.stages["encode_transform"](b, xytp, n_valid)
        dets_b, keep_b = run_step.stages["detect"](inp)
        assert torch.equal(flat(a.memory), flat(b.memory))
        assert torch.equal(a.queue, b.queue)
        assert torch.equal(keep_a, keep_b) and torch.equal(dets_a, dets_b)


def test_reset_of_one_stream_changes_only_that_stream(params):
    run_step, _ = served(params)
    ws = windows(6)
    a = pipeline.new_state(B, HW, device="cpu")
    b = pipeline.new_state(B, HW, device="cpu")
    for xytp, n_valid in ws[:3]:
        a, _ = run_step(a, xytp, n_valid)
        b, _ = run_step(b, xytp, n_valid)
    b.reset([1])
    assert b.fresh == {1}
    assert float(flat(tuple((h[1], c[1]) for h, c in b.memory)).abs().max()
                 ) == 0.0
    with profiling.recording():
        for xytp, n_valid in ws[3:]:
            a, (dets_a, keep_a) = run_step(a, xytp, n_valid)
            b, (dets_b, keep_b) = run_step(b, xytp, n_valid)
        records = profiling.span_records()[-200:]
    counts = [r.counts for r in records if r.name == "serve.forward"]
    assert {"memory_fresh": 1, "memory_carried": B - 1} in counts
    for (ha, ca), (hb, cb) in zip(a.memory, b.memory):
        assert torch.equal(ha[0], hb[0]) and torch.equal(ca[0], cb[0])
        assert not torch.equal(ca[1], cb[1])
    assert torch.equal(a.queue[0], b.queue[0])
    assert not torch.equal(a.queue[1], b.queue[1])
    assert torch.equal(dets_a[0], dets_b[0]) and torch.equal(keep_a[0],
                                                             keep_b[0])

    # the reset stream is the stream a fresh state would give
    c = pipeline.new_state(B, HW, device="cpu")
    for xytp, n_valid in ws[3:]:
        c, _ = run_step(c, xytp, n_valid)
    for (hb, cb), (hc, cc) in zip(b.memory, c.memory):
        assert torch.equal(hb[1], hc[1]) and torch.equal(cb[1], cc[1])


def test_builder_takes_red_and_refuses_other_pyramids():
    model = build_detector(7, family="red", input_channels=16,
                           in_channels=RED_IN_CHANNELS, strides=RED_STRIDES)
    assert isinstance(model, REDDetector) and not model.training
    # the AED's arguments at their defaults are taken, as left out
    build_detector(7, family="red", input_channels=16,
                   in_channels=RED_IN_CHANNELS, strides=RED_STRIDES,
                   stem="focus", depth=0.33, head_width=256)
    with pytest.raises(ValueError, match="SSD pyramid"):
        build_detector(7, family="red")
    with pytest.raises(ValueError, match="SSD pyramid"):
        build_detector(7, family="red", in_channels=(128,) * 5,
                       strides=RED_STRIDES)
    with pytest.raises(ValueError, match="AED's arguments"):
        build_detector(7, family="red", in_channels=RED_IN_CHANNELS,
                       strides=RED_STRIDES, stem="bfm")
    with pytest.raises(ValueError, match="REDDetector"):
        pipeline.make_pipeline_recurrent(build_detector(2), HW, HW,
                                         device="cpu")
