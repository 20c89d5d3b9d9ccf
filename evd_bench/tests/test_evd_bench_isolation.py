"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole: frlw_evd_tpu_torch begins with frlw_evd_tpu), the
reference imports nothing of the program, a run without a card gives no
result, and the reference's parameters are the served model's."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from evd_bench import harness
from evd_bench.reference import aed

HERE = harness.HERE
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "frlw_evd_tpu"}


def imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import_in_source(path):
    bad = [n for n in imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in imports(path)}
    assert tops <= {"__future__", "math", "torch", "evd_bench"}, tops
    text = path.read_text()
    assert "frlw_evd_tpu" not in text


def test_a_run_loads_no_jax():
    """A tiny CPU run in a fresh process, then the modules it holds."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.insert(0, {str(HERE / 'tests')!r})\n"
        "import tempfile, pathlib\n"
        "from conftest import write_tiny\n"
        "from evd_bench import harness, run\n"
        "root = pathlib.Path(tempfile.mkdtemp())\n"
        "bench = harness.Bench(write_tiny(root), roots=(root, harness.HERE))\n"
        "harness.run(bench, 'tiny_gen1_cell', 3, 0.1, True,\n"
        "            torch.device('cpu'), time.perf_counter())\n"
        "print(run.loaded_forbidden())\n"
        "sys.modules['jax'] = sys\n"
        "print(run.loaded_forbidden())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['jax']"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "evd_bench/run.py", "--workload", "gen1_serve_b128",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA" in res.stderr


@pytest.mark.parametrize("config", ["aed_gen1", "aed_gen4"])
def test_reference_parameters_are_the_served_models(config):
    from frlw_evd_tpu_torch.models.detector import build_detector

    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    m = dict(cfg["model"])
    model = build_detector(m.pop("num_classes"), **m)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: tuple(shape) for name, shape, _ in aed.param_spec(
        cfg["model"])}
    assert got == want
