"""The harness: finds a cell's pieces by name and runs it once.

Everything that belongs to one configuration, traffic mix, driver, check,
model family, cell or per-layer metric sits in a file of its own under a
root (evd_bench/ by default), found by the name BENCHMARK.json, the cell
file or the configuration gives it:

  configs/<config>.json      the model (its "family"), sizes, the program's
                             factory and its arguments, the precisions
  traffic/<traffic>.json     the parameters its generator reads
  generators/<kind>.py       one kind of event window (generate.py)
  drivers/<driver>.py        run(ctx) -> the window: set-up, warm-up, the
                             measured loop, what the check needs
  checks/<check>.py          compare(ctx, window) -> {number: reading}
  reference/<family>.py      the plain reference of a model family
  roofline/<family>.py       its FLOPs a window; roofline/<kernel>.py
  cells/<cell>.json          config, traffic, driver, check and its limits
  metrics/<metric>.py        read(ctx) -> the per-layer metric, or None

This module only looks the pieces up and puts the result line together;
a cell with another loop, another system or other numbers to compare
brings its own driver and check, and this module and run.py stay as they
are.
"""

from __future__ import annotations

import gc
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import torch

from evd_bench import check

HERE = Path(__file__).resolve().parent
SPEC = HERE.parent / "BENCHMARK.json"


class Bench:
    """BENCHMARK.json (`spec`, a dict or a path) and the roots searched,
    in order, for each named file."""

    def __init__(self, spec=SPEC, roots=(HERE,)):
        self.spec = spec if isinstance(spec, dict) else json.loads(
            Path(spec).read_text())
        self.roots = [Path(r) for r in roots]
        self._modules = {}

    def path(self, kind: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def code(self, kind: str, name: str):
        """The module `<kind>/<name>.py`, loaded once a Bench."""
        path = self.path(kind, name, ".py")
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"evd_bench._{kind}_{name.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, table: str, cell: str):
        """The entries of `table` ("end_to_end" or "per_layer") that
        `cell` reports."""
        return [m for m in self.spec[table]
                if cell in m.get("workloads", (cell,))]


def free(device):
    """Drop what Python no longer holds and return the device's cached
    blocks."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
        device, t0: float, build=None):
    """One run of cell `name`; t0 is the process's start on the host
    clock. `build`, where given, makes the system under test in the
    program's place (the control and the harness's tests use it); the
    driver passes it what it passes the program. Returns (result line as a
    dict, [(number, reading, limit)])."""
    work = bench.workload(name)
    cell = bench.json("cells", name)
    if (cell["config"], cell["traffic"]) != (work["config"], work["traffic"]):
        raise ValueError(f"cells/{name}.json names {cell['config']}, "
                         f"{cell['traffic']}; BENCHMARK.json "
                         f"{work['config']}, {work['traffic']}")
    ctx = SimpleNamespace(
        bench=bench, name=name, cell=cell,
        cfg=bench.json("configs", cell["config"]),
        traffic=bench.json("traffic", cell["traffic"]),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
        build=build)
    checker = bench.code("checks", cell["check"]["name"])
    ctx.window = bench.code("drivers", cell["driver"]).run(ctx, checker)
    out = ctx.window
    readings = checker.compare(ctx, out)
    correct, rows = check.judge(readings, cell["check"]["limits"])

    if trace:
        ctx.profile = out.get("profile")
        table = bench.metrics("per_layer", name)
        values = {m["name"]: bench.code("metrics", m["name"]).read(ctx)
                  for m in table}
    else:
        table = bench.metrics("end_to_end", name)
        values = {**out["end_to_end"], "setup_s": out["t_start"] - t0}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in table if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": work["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and out.get("profile"):
        dev["busy_s"] = out["profile"]["busy_s"]
        dev["window_s"] = out["profile"]["window_s"]
        result["breakdown"] = out["profile"]["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
