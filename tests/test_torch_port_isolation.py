"""The port stays separate from the JAX package and from JAX itself, and
no entry point falls back to the CPU on its own."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "frlw_evd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "frlw_evd_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_port_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device=, the pipeline asks for CUDA and raises where there
    is none, instead of quietly running the plain twins on the CPU."""
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.models import build_detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_detector(2, stem="bfm", in_channels=(16, 16, 16),
                           stem_out_channels=8, head_width=16)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.make_pipeline_kernel(model, (60, 72), (64, 96))
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.new_state(2, (60, 72))
    p64_model = build_detector(2, stem="bfm_folded", in_channels=(16, 16, 16),
                               stem_out_channels=8, head_width=16)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.make_pipeline_p64(p64_model, (64, 96), folded=True)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.new_state(2, (64, 96), p64=True)


def test_kernel_wrappers_take_no_other_device():
    """A tensor that is not on the CPU never reaches a plain twin."""
    from frlw_evd_tpu_torch.encode import (scatter_cnt_tsum, taf_update_leaky,
                                           taf_update_leaky_raw,
                                           taf_update_leaky_v2)
    from frlw_evd_tpu_torch.models.stem_chain import (bfm_chain_apply,
                                                      bfm_chain_apply_folded)

    ev = torch.zeros(2, 8, 4, device="meta")
    nv = torch.zeros(2, dtype=torch.int32, device="meta")
    for layout in ("folded", "p64"):
        with pytest.raises(ValueError, match="unsupported device"):
            scatter_cnt_tsum(ev, nv, height=4, width=4, layout=layout)
    st = torch.zeros(2, 4, 64, device="meta")
    cnt = torch.zeros(2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        taf_update_leaky(st, cnt, cnt, nv, height=4, width=4)
    st64 = torch.zeros(2, 2, 16 * 64, device="meta")
    cnt64 = torch.zeros(2, 4 * 32 * 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        taf_update_leaky_raw(st64, cnt64, cnt64, nv, height=4, width=32)
    with pytest.raises(ValueError, match="unsupported device"):
        taf_update_leaky_v2(st64, cnt64.view(2, 2, -1), cnt64.view(2, 2, -1),
                            nv, height=2, width=64)
    vol = torch.zeros(2, 2, 16, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bfm_chain_apply(vol, {})
    with pytest.raises(ValueError, match="unsupported device"):
        bfm_chain_apply_folded(vol.view(2, 2, 16 * 64), {}, width=16)


@pytest.mark.parametrize("name", ["scatter_cnt_tsum_pallas_sorted",
                                  "scatter_cnt_tsum_pallas"])
def test_cell_histogram_kernels_take_no_other_device(name):
    """Kernels B6 and B8 take cell indices; neither hands a tensor that is
    not on the CPU to its twin."""
    from frlw_evd_tpu_torch import encode

    idx = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    t = torch.zeros(2, 8, device="meta")
    valid = torch.zeros(2, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(encode, name)(idx, t, valid, 32)


def test_csrc_sources_include_nothing_of_torch_or_jax():
    """The kernels keep a plain C interface (pointers, ints, the stream),
    so nvcc builds them in seconds without PyTorch's headers."""
    for path in sorted((PKG / "csrc").glob("*.cu*")):
        text = path.read_text()
        for bad in ("torch/", "ATen/", "c10/", "pybind11", "jax", "xla"):
            assert f"#include <{bad}" not in text and \
                f'#include "{bad}' not in text, f"{path.name} includes {bad}"
        assert path.suffix != ".cu" or 'extern "C"' in text, \
            f"{path.name} has no C entry"


@pytest.mark.parametrize("stem,folded", [("bfm_folded", False),
                                         ("bfm_p64_kernel", True)])
def test_p64_pipeline_refuses_a_fold_the_stem_does_not_take(stem, folded):
    """`folded` must agree with the stem: the folded volume goes to
    bfm_folded only, the NHWC view to the other p64 stems."""
    from frlw_evd_tpu_torch import pipeline
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(2, stem=stem, in_channels=(16, 16, 16),
                           stem_out_channels=8, head_width=16)
    with pytest.raises(ValueError, match="does not fit the model's stem"):
        pipeline.make_pipeline_p64(model, (64, 96), folded=folded,
                                   device="cpu")
