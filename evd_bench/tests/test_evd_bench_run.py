"""A run of a tiny cell on the CPU, start to end: the result line's
schema, a correct sound run, and `correct` false for the control and for
each fault a serving cell can have."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from evd_bench import harness, program
from evd_bench.reference import control

CELLS = ("tiny_gen1_cell", "tiny_gen4_cell")
CPU = torch.device("cpu")


def run(bench, cell, trace=False, build=None, seed=2 ** 31 + 7):
    return harness.run(bench, cell, seed, 0.2, trace, CPU,
                       time.perf_counter(), build=build)


def check_schema(result, trace):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            rows = result["breakdown"][key]
            assert 0 < len(rows) <= 10
            assert all(isinstance(n, str) and s >= 0 for n, s in rows)
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result, rows = run(tiny, cell)
    check_schema(result, trace=False)
    assert set(result["metrics"]) == {"windows_per_s", "window_p95_ms",
                                      "setup_s"}
    assert result["correct"], rows


def test_traced_run_schema(tiny):
    result, rows = run(tiny, "tiny_gen1_cell", trace=True)
    check_schema(result, trace=True)
    assert "windows_per_s" not in result["metrics"]
    assert result["correct"], rows


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    result, rows = run(tiny, cell, build=control.build)
    failed = {k for k, v, lim in rows if not v <= lim}
    assert not result["correct"]
    assert {"state_gap", "volume_gap", "head_gap", "post_mismatch"} <= failed


def faulty(kind):
    """program.build with the timed path broken underneath."""
    def build(cfg, params, batch, device):
        s = program.build(cfg, params, batch, device)

        def run_step(state, xytp, n_valid):
            if kind == "half_batch":       # the second half's events dropped
                n_valid = torch.cat([n_valid[:batch // 2],
                                     torch.zeros_like(n_valid[batch // 2:])])
            before = state.clone()
            state, (dets, keep) = s.run_step(state, xytp, n_valid)
            if kind == "state_unchanged":
                state.copy_(before)
            if kind == "answer_altered":   # the first kept box moved
                dets = dets.clone()
                dets[0, int(keep[0].float().argmax()), 0] += 0.5
            return state, (dets, keep)

        run_step.stages = s.stages
        return s._replace(run_step=run_step)
    return build


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_fault_is_not_correct(tiny, kind):
    result, rows = run(tiny, "tiny_gen1_cell", build=faulty(kind))
    assert not result["correct"], rows


def test_cell_added_from_files_alone(tmp_path, tiny):
    """A new cell, traffic mix with a new kind of window, driver and
    per-layer metric, each a new file under a new root, run without an
    edit to the harness."""
    root = tmp_path / "added"
    for kind in ("cells", "traffic", "generators", "drivers", "metrics"):
        (root / kind).mkdir(parents=True)
    cell = json.loads(tiny.path("cells", "tiny_gen1_cell", ".json")
                      .read_text())
    cell.update(name="added_cell", traffic="ring_mix", driver="loop2")
    (root / "cells" / "added_cell.json").write_text(json.dumps(cell))
    mix = json.loads((harness.HERE / "traffic" / "events_mixed.json")
                     .read_text())
    mix.update(pool=3, kinds=mix["kinds"][1:] + [{"kind": "ring", "r": 5}])
    (root / "traffic" / "ring_mix.json").write_text(json.dumps(mix))
    (root / "generators" / "ring.py").write_text(
        "import math\n\nimport torch\n\n\n"
        "def draw(gen, n, batch, E, h, w, device, p, first_step, period):\n"
        "    a = torch.rand(n, batch, E, generator=gen, device=device)\n"
        "    x = (w / 2 + p['r'] * torch.cos(2 * math.pi * a)).floor()\n"
        "    y = (h / 2 + p['r'] * torch.sin(2 * math.pi * a)).floor()\n"
        "    t = torch.sort(a, dim=2).values\n"
        "    ev = torch.stack([x, y, t, (a > 0.5).float()], -1)\n"
        "    return ev, torch.full((n, batch), E, dtype=torch.int32,\n"
        "                          device=device)\n")
    (root / "drivers" / "loop2.py").write_text(
        "from evd_bench.drivers.serve_closed import run as _run\n\n\n"
        "def run(ctx, checker):\n"
        "    out = _run(ctx, checker)\n"
        "    out['end_to_end']['steps_done'] = float(out['steps'])\n"
        "    return out\n")
    (root / "metrics" / "steps_profiled.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx.profile['pool_windows']))\n")
    spec = dict(tiny.spec)
    spec["workloads"] = spec["workloads"] + [
        {"name": "added_cell", "config": "tiny_gen1",
         "traffic": "ring_mix", "chips": 1, "why": "added"}]
    spec["end_to_end"] = spec["end_to_end"] + [
        {"name": "steps_done", "unit": "steps", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["added_cell"]}]
    spec["per_layer"] = spec["per_layer"] + [
        {"name": "steps_profiled", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "device",
         "moves": "windows_per_s", "workloads": ["added_cell"]}]
    bench = harness.Bench(spec, roots=(root, *tiny.roots))
    result, rows = run(bench, "added_cell")
    assert result["correct"], rows
    assert result["metrics"]["steps_done"]["value"] >= 1
    result, rows = run(bench, "added_cell", trace=True)
    assert result["metrics"]["steps_profiled"]["value"] == cell[
        "profile_steps"]


# A family, traffic, driver and check that share nothing with the serving
# cells: a linear model trained by SGD, whose step takes a batch of rows
# and returns a loss, checked on its losses against a reference.
TOY_FILES = {
    "configs/toy_lin.json": json.dumps({
        "name": "toy_lin", "model": {"family": "toy_lin", "features": 8,
                                     "outputs": 2},
        "weights_seed": 0, "lr": 0.05}),
    "traffic/toy_rows.json": json.dumps({"pool": 4, "rows": 32,
                                         "noise": 0.1}),
    "reference/toy_lin.py": """
import torch


def param_spec(m):
    return [("weight", (m["outputs"], m["features"]), "conv"),
            ("bias", (m["outputs"],), "zero")]


def losses(params, batches, lr):
    w, b = params["weight"].double(), params["bias"].double()
    out = []
    for x, y in batches:
        x, y = x.double(), y.double()
        err = x @ w.T + b - y
        out.append(float((err * err).mean()))
        g = 2 * err / err.numel()
        w, b = w - lr * g.T @ x, b - lr * g.sum(0)
    return out
""",
    "drivers/toy_train.py": """
import time

import torch

from evd_bench import weights


def build(cfg, params, device):
    m = cfg["model"]
    net = torch.nn.Linear(m["features"], m["outputs"]).to(device)
    net.load_state_dict(params)
    opt = torch.optim.SGD(net.parameters(), lr=cfg["lr"])

    def step(x, y):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        return float(loss.detach())
    return step


def run(ctx, checker):
    cfg, tr, device = ctx.cfg, ctx.traffic, ctx.device
    family = ctx.bench.code("reference", cfg["model"]["family"])
    params = weights.make_params(family.param_spec(cfg["model"]),
                                 cfg["weights_seed"], device)
    step = (ctx.build or build)(cfg, params, device)
    gen = weights.generator(ctx.seed, 2, device)
    m = cfg["model"]
    x = torch.randn(tr["pool"], tr["rows"], m["features"], generator=gen,
                    device=device)
    y = x[..., :m["outputs"]] + tr["noise"] * torch.randn(
        tr["pool"], tr["rows"], m["outputs"], generator=gen, device=device)
    first = [step(x[i], y[i]) for i in range(3)]
    t_start = time.perf_counter()
    n = 0
    while time.perf_counter() - t_start < ctx.seconds:
        step(x[(3 + n) % tr["pool"]], y[(3 + n) % tr["pool"]])
        n += 1
    elapsed = time.perf_counter() - t_start
    return {"t_start": t_start, "attempted": n * tr["rows"], "failed": 0,
            "end_to_end": {"windows_per_s": n * tr["rows"] / elapsed},
            "memory_peak_bytes": 0, "first_losses": first,
            "batches": [(x[i], y[i]) for i in range(3)]}
""",
    "checks/toy_loss.py": """
from evd_bench import weights


def compare(ctx, window):
    cfg = ctx.cfg
    family = ctx.bench.code("reference", cfg["model"]["family"])
    params = weights.make_params(family.param_spec(cfg["model"]),
                                 cfg["weights_seed"], ctx.device)
    ref = family.losses(params, window["batches"], cfg["lr"])
    gap = max(abs(a - b) / abs(b)
              for a, b in zip(window["first_losses"], ref))
    return {"loss_gap": gap}
""",
    "metrics/first_loss.py": """
def read(ctx):
    return ctx.window["first_losses"][0]
""",
    "cells/toy_cell.json": json.dumps({
        "name": "toy_cell", "config": "toy_lin", "traffic": "toy_rows",
        "driver": "toy_train",
        "check": {"name": "toy_loss", "limits": {"loss_gap": 1e-5}},
        "why": "t"}),
}


def toy_bench(root: Path) -> harness.Bench:
    for rel, text in TOY_FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    spec = json.loads(harness.SPEC.read_text())
    spec["workloads"] = [{"name": "toy_cell", "config": "toy_lin",
                          "traffic": "toy_rows", "chips": 1, "why": "t"}]
    spec["end_to_end"] = [dict(m, workloads=["toy_cell"])
                          for m in spec["end_to_end"]
                          if m["name"] in ("windows_per_s", "setup_s")]
    spec["per_layer"] = [{"name": "first_loss", "unit": "1",
                          "better": "lower", "source": "program_counter",
                          "layer": "model step", "moves": "windows_per_s"}]
    return harness.Bench(spec, roots=(root, harness.HERE))


def test_other_driver_and_check_from_files_alone(tmp_path):
    """A cell whose family, traffic, driver (a training step with another
    signature), check (numbers of its own) and metric are all new files:
    the harness runs it as it stands, and its check catches a step that
    leaves the weights unchanged."""
    bench = toy_bench(tmp_path)
    result, rows = run(bench, "toy_cell")
    check_schema(result, trace=False)
    assert set(result["metrics"]) == {"windows_per_s", "setup_s"}
    assert result["correct"] and [r[0] for r in rows] == ["loss_gap"], rows
    result, rows = run(bench, "toy_cell", trace=True)
    assert set(result["metrics"]) == {"first_loss"}

    def frozen(cfg, params, device):
        step = bench.code("drivers", "toy_train").build(
            dict(cfg, lr=0.0), params, device)
        return step
    result, rows = run(bench, "toy_cell", build=frozen)
    assert not result["correct"], rows
