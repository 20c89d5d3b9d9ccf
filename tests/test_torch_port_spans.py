"""The port's spans and counters (utils/profiling.py: span, count,
recording, spans_summary) on the two serving paths the benchmark runs,
`make_pipeline_kernel` (GEN1 form) and `make_pipeline_p64(folded=True)`
(1 Mpx form), at tiny widths on the CPU, and the benchmark's six readers
of them (evd_bench/spans.py, evd_bench/metrics/) over a tiny traced cell.

Off (no profiler, no recording block), a site stores nothing and never
enters record_function. Under torch.profiler every span appears in the
trace inside its parent, and the spans of one step share its number. The
`nms_rounds` and `host_syncs` counters equal a hand count of the fixpoint
rounds."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.postprocess import (_suppression_edges,
                                                   cxcywh_to_xyxy,
                                                   postprocess_batch)
from frlw_evd_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
TINY = dict(in_channels=(16, 16, 16), stem_out_channels=8, head_width=16)
B, E = 2, 256

# each span on a serving path and the span it runs inside
PARENTS = {"serve.encode": None, "serve.detect": None,
           "kernel.b1": "serve.encode", "kernel.b2": "serve.encode",
           "kernel.b3": "serve.encode", "kernel.b4": "serve.forward",
           "serve.forward": "serve.detect", "serve.decode": "serve.detect",
           "serve.post": "serve.detect", "serve.select": "serve.post",
           "serve.nms_round": "serve.post", "host_sync": "serve.nms_round"}
PATHS = {
    "gen1": ("bfm", 2, (30, 60), {"kernel.b1", "kernel.b2"}),
    "gen4": ("bfm_folded", 7, (32, 64), {"kernel.b1", "kernel.b3",
                                         "kernel.b4"}),
}
SERVE = {"serve.encode", "serve.detect", "serve.forward", "serve.decode",
         "serve.post", "serve.select", "serve.nms_round", "host_sync"}


def _serving(path: str):
    """run_step of the tiny path, a fresh state and two steps of events."""
    stem, classes, sensor, _ = PATHS[path]
    torch.manual_seed(0)
    model = build_detector(classes, stem=stem, **TINY)
    if path == "gen1":
        run = pipeline.make_pipeline_kernel(model, sensor, (32, 64),
                                            device="cpu",
                                            dtype=torch.float32)
    else:
        run = pipeline.make_pipeline_p64(model, sensor, folded=True,
                                         device="cpu", dtype=torch.float32)
    ev, nv = pipeline.synth_events(np.random.default_rng(3), 2, B, E, sensor)
    state = pipeline.new_state(B, sensor, p64=path == "gen4", device="cpu")
    return run, state, torch.from_numpy(ev), torch.from_numpy(nv)


def _steps(run, state, ev, nv):
    for i in range(ev.shape[0]):
        state, (dets, keep) = run(state, ev[i], nv[i])
    return dets, keep


def _fixpoint_rounds(decoded, max_detections):
    """The fixpoint NMS rounds of postprocess_batch on `decoded`, counted
    by hand: the same selection, then one keep update a round until none
    changes."""
    K = min(max_detections, decoded.shape[1])
    obj = decoded[..., 4]
    scores = torch.where(obj > 0.3, obj, -1.0)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :K], idx[:, :K]
    boxes = cxcywh_to_xyxy(torch.gather(
        decoded[..., :4], 1, idx[..., None].expand(-1, -1, 4)))
    valid = top > 0.3
    edge = _suppression_edges(boxes, 0.6)
    keep, rounds = valid, 0
    while True:
        rounds += 1
        new = valid & ~(edge & keep[..., :, None]).any(dim=-2)
        if bool((new == keep).all()):
            return rounds, keep
        keep = new


def test_off_stores_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    profiling.clear_spans()
    assert profiling.span("serve.detect") is profiling.span("x")
    for path in PATHS:
        _steps(*_serving(path))
    assert profiling.span_records() == []
    assert profiling.spans_summary() == {"steps": 0, "spans": {},
                                         "counts": {}}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_nest_in_the_trace_and_share_the_step(path):
    run, state, ev, nv = _serving(path)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(run, state, ev, nv)
    names = SERVE | PATHS[path][3]
    events = {}
    for e in prof.events():
        if e.name in PARENTS and e.device_type == DeviceType.CPU:
            events.setdefault(e.name, []).append(e.time_range)
    assert set(events) == names
    for name, ranges in events.items():
        parent = PARENTS[name]
        if parent is None:
            continue
        for r in ranges:
            assert any(p.start <= r.start and r.end <= p.end
                       for p in events[parent]), (name, parent)

    records = profiling.span_records()
    assert {r.name for r in records} == names
    steps = {}
    for r in records:
        assert (r.parent.name if r.parent else None) == PARENTS[r.name]
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns \
                <= r.parent.end_ns
            assert r.step == r.parent.step
        steps.setdefault(r.step, []).append(r.name)
    assert len(steps) == 2
    for got in steps.values():
        assert set(got) == names
        assert got.count("serve.encode") == got.count("serve.detect") == 1
        assert got.count("host_sync") == got.count("serve.nms_round")
    summary = profiling.spans_summary()
    assert summary["steps"] == 2
    assert summary["counts"]["nms_rounds"] == summary["counts"][
        "host_syncs"] == summary["spans"]["serve.nms_round"]["calls"]
    assert all(s["device_ms"] is None for s in summary["spans"].values())


@pytest.mark.parametrize("chain", [1, 3, 6])
def test_nms_counters_equal_a_hand_count(chain):
    """Each row holds a chain of chain + 1 boxes 3 px apart (20 px wide:
    IoU 0.74 with the next box, 0.54 with the one after), scores falling,
    so each round settles one more link, among random boxes."""
    g = torch.Generator().manual_seed(chain)
    n, A = 3, 40
    decoded = torch.zeros(n, A, 7)
    decoded[..., :2] = torch.rand(n, A, 2, generator=g) * 500
    decoded[..., 2:4] = 8.0
    decoded[..., 4] = torch.rand(n, A, generator=g) * 0.5 + 0.2
    decoded[..., 5:] = torch.rand(n, A, 2, generator=g)
    for row in range(n):
        for i in range(chain + 1):
            decoded[row, i, :4] = torch.tensor([100.0 + 3 * i, 50, 20, 20])
            decoded[row, i, 4] = 0.99 - 0.01 * i
    want, keep_hand = _fixpoint_rounds(decoded, 30)
    profiling.clear_spans()
    with profiling.recording():
        with profiling.span("serve.post", new_step=True):
            _, keep = postprocess_batch(decoded, max_detections=30)
    counts = profiling.spans_summary()["counts"]
    assert want >= chain + 1
    assert counts == {"nms_rounds": want, "host_syncs": want}
    assert torch.equal(keep, keep_hand)
    _, seq = postprocess_batch(decoded, max_detections=30,
                               nms_impl="sequential")
    assert torch.equal(keep, seq)


def test_recording_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    profiling.clear_spans()
    with profiling.recording():
        with profiling.span("outer", new_step=True) as outer:
            profiling.count("c", 2)
            with profiling.span("inner"):
                profiling.count("c")
                profiling.count("d", 5)
        with profiling.span("outer", new_step=True):
            pass
    profiling.count("c", 100)  # no span open: counted nowhere
    with profiling.span("after"):
        pass  # recording closed: not stored
    records = profiling.span_records()
    assert [r.name for r in records] == ["outer", "inner", "outer"]
    assert records[1].parent is outer and outer.counts == {"c": 2}
    assert records[0].step == records[1].step != records[2].step
    s = profiling.spans_summary()
    assert s["steps"] == 2
    assert s["counts"] == {"c": 3, "d": 5}
    assert s["spans"]["outer"]["calls"] == 2
    assert s["spans"]["inner"]["host_ms"] <= s["spans"]["outer"]["host_ms"]
    assert s["spans"]["inner"]["device_ms"] is None
    later = time.perf_counter_ns()
    assert profiling.spans_summary(since_ns=later)["steps"] == 0
    profiling.clear_spans()
    assert profiling.span_records() == []


READERS = {"forward_ms": None, "post_ms": None, "nms_rounds": float,
           "host_syncs": float, "sync_wait_ms": float,
           "host_enqueue_ms": float}


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    sys.path.insert(0, str(REPO))
    from evd_bench import harness
    from evd_bench.tests.conftest import write_tiny
    root = tmp_path_factory.mktemp("tiny")
    return harness, harness.Bench(write_tiny(root),
                                  roots=(root, harness.HERE))


@pytest.mark.parametrize("system", ["program", "control"])
def test_the_six_readers_over_a_tiny_traced_cell(tiny_bench, system):
    harness, bench = tiny_bench
    from evd_bench.reference import control
    build = control.build if system == "control" else None
    result, _ = harness.run(bench, "tiny_gen1_cell", 2 ** 31 + 11, 0.2, True,
                            torch.device("cpu"), time.perf_counter(),
                            build=build)
    got = {k: result["metrics"].get(k, {}).get("value") for k in READERS}
    if system == "control":
        assert got == dict.fromkeys(READERS)
        return
    assert result["correct"]
    for name, kind in READERS.items():
        assert (got[name] is None) if kind is None else isinstance(
            got[name], kind), (name, got[name])
    assert got["nms_rounds"] >= 1 and got["host_syncs"] == got["nms_rounds"]
    assert 0 <= got["sync_wait_ms"] < got["host_enqueue_ms"]
    labels = {k for k, _ in result["breakdown"]["idle_gaps"]}
    assert not labels & {"evd_bench.encode", "evd_bench.detect"}
