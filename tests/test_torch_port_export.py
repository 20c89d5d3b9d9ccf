"""The port's serving export (frlw_evd_tpu_torch/tools/export_model.py)
on the CPU: torch.export of the serving step, saved and loaded again.

A small bf16 export and the CLI's `--width 64 --fuse --int8 --check`
export, each with the BatchNorm affines spread and the obj biases raised
(pipeline.spread_random_weights_) so that boxes pass conf 0.3 and NMS
suppresses some: the loaded program's keep equals the live step's and its
dets are equal bit for bit (the same operators on the CPU); the int8
program calls frlw_evd_torch::int8_conv2d once a site. The live serving step (f32 weights, the volume rounded to bf16 as
the JAX contract has it) against JAX's build_serving_fn on the same f32
weights carried by weights.py, both in f32 on one bf16-rounded volume
(JAX's module reads jnp.bfloat16 as float32 for it): keep equal and the
kept rows within rtol 1e-4, atol 1e-3, the gates of
test_torch_port_pipeline.py. The K-round NMS of the exported step against
the early-exit fixpoint and the sequential reference.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models.postprocess import (nms_mask,
                                                   nms_mask_rounds,
                                                   nms_mask_sequential)
from frlw_evd_tpu_torch.tools import export_model as ex
from frlw_evd_tpu_torch.weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HW = (64, 96)
OP = torch.ops.frlw_evd_torch.int8_conv2d.default


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this process while the file runs: small ops
    stall on the thread pool's barriers when the suite's other workers
    hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spread_model(cfg):
    model = ex.build_model(cfg)
    return pipeline.spread_random_weights_(model,
                                           torch.Generator().manual_seed(1))


def _vol(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))


@pytest.fixture(scope="module")
def cli_int8(tmp_path_factory):
    """The CLI's `--width 64 --fuse --int8 --check` export of the spread
    weights, saved as a checkpoint: (cfg, checkpoint, .pt2, stdout)."""
    root = tmp_path_factory.mktemp("export")
    cfg = ex.config(img_hw=HW, width=64)
    ckpt = str(root / "spread")
    torch.save({"model": _spread_model(cfg).state_dict()}, ckpt)
    out = str(root / "m8.pt2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex.main(["--out", out, "--img_hw", *map(str, HW), "--width", "64",
                 "--fuse", "--int8", "--check", "--ckpt", ckpt, "--batch",
                 "2", "--device", "cpu"])
    return cfg, ckpt, out, buf.getvalue()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_export_round_trip(tmp_path, kind, cli_int8):
    """bf16: exported here; int8: the CLI's program, against the live step
    built here from the same checkpoint."""
    if kind == "bf16":
        cfg = ex.config(img_hw=HW, small=True)
        step, shape, n_sites = ex.build_serving_fn(
            cfg, _spread_model(cfg), 2, device="cpu")
        path = str(tmp_path / "m.pt2")
        torch.export.save(ex.export(step, shape, "cpu"), path)
    else:
        cfg, ckpt, path, _ = cli_int8
        step, shape, n_sites = ex.build_serving_fn(
            cfg, ex.build_model(cfg, ckpt), 2, device="cpu", fuse=True,
            int8=True)
    loaded = torch.export.load(path)
    calls = sum(node.target is OP for node in loaded.graph.nodes)
    assert calls == n_sites and (n_sites > 30) == (kind == "int8")
    vol = _vol(shape)
    with torch.no_grad():
        live_dets, live_keep = step(vol)
        dets, keep = loaded.module()(vol)
    assert torch.equal(keep, live_keep)
    assert torch.equal(dets, live_dets)
    valid = live_dets[..., 5] > 0
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_cli_check_passes(cli_int8):
    _, _, out, stdout = cli_int8
    assert "int8: 34 conv sites quantized" in stdout
    assert "roundtrip check ok" in stdout
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["int8_sites"] == 34 and meta["fused"]
    assert meta["input"]["shape"] == [2, *HW, 16]


def test_kernel_stems_are_refused():
    cfg = ex.config(img_hw=HW, small=True)
    cfg.stem = "bfm_folded"
    with pytest.raises(ValueError, match="ctypes"):
        ex.build_model(cfg)


class _JnpF32:
    """jax.numpy with bfloat16 read as float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_live_step_matches_jax_build_serving_fn(monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import export_model as j_export
    from frlw_evd_tpu.models import build_detector as j_build_detector
    from frlw_evd_tpu.train.config import make_config as j_make_config

    # both steps in f32 on the same bf16-rounded volume: JAX's serve casts
    # the volume to bf16 and its stem's weight-norm kernels to the input's
    # dtype, so JAX would round there where the port's f32 model does not
    monkeypatch.setattr(j_export, "jnp", _JnpF32())
    j_cfg = j_make_config("taf_bfm", dataset="gen1", event_volume_bins=8,
                          augmentation=False)
    j_cfg.img_size_override = HW
    j_cfg.in_channels = (32, 32, 32)
    jm = j_build_detector(j_cfg.num_classes, family=j_cfg.family,
                          stem=j_cfg.stem, act=j_cfg.act,
                          strides=j_cfg.strides,
                          in_channels=j_cfg.in_channels, depth=j_cfg.depth)
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *HW, 16)), False)
    rng = np.random.default_rng(0)
    flat = {}
    for path, a in flatten_dict(jax.tree.map(np.array,
                                             variables["params"])).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 2.0, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.5, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = 2.0
        flat[path] = a
    params = unflatten_dict(flat)
    stats = jax.tree.map(np.array, variables["batch_stats"])

    cfg = ex.config(img_hw=HW, small=True)
    model = load_flax_variables(ex.build_model(cfg),
                                {"params": params, "batch_stats": stats})
    step, shape, _ = ex.build_serving_fn(cfg, model, 2, device="cpu",
                                         dtype=torch.float32)
    serve, j_shape, _ = j_export.build_serving_fn(j_cfg, params, stats, 2)
    assert tuple(j_shape) == shape
    vol = _vol(shape, seed=3).bfloat16().float()
    with torch.no_grad():
        dets, keep = step(vol)
    j_dets, j_keep = (np.asarray(a) for a in jax.jit(serve)(
        jnp.asarray(vol.numpy())))
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    valid = j_dets[..., 5] > 0
    assert j_keep.sum() > 0 and (valid & ~j_keep).sum() > 0
    np.testing.assert_allclose(dets.numpy()[j_keep], j_dets[j_keep],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k_round_nms_equals_the_early_exit(seed):
    """Random overlapping boxes, and a chain in which each box overlaps the
    next, so the fixpoint needs as many rounds as boxes."""
    g = torch.Generator().manual_seed(seed)
    K = 100
    xy = torch.rand(4, K, 2, generator=g) * 60
    wh = torch.rand(4, K, 2, generator=g) * 30 + 5
    boxes = torch.cat([xy, xy + wh], -1)
    chain = torch.arange(K, dtype=torch.float32)[:, None] * 4.0
    boxes[0] = torch.cat([chain, torch.zeros(K, 1), chain + 10.0,
                          torch.full((K, 1), 10.0)], -1)
    valid = torch.rand(4, K, generator=g) < 0.9
    valid[0] = True
    scores = torch.rand(4, K, generator=g)
    for t in (0.3, 0.6):
        want = nms_mask_sequential(boxes, scores, valid, t)
        assert torch.equal(nms_mask(boxes, scores, valid, t), want)
        assert torch.equal(nms_mask_rounds(boxes, scores, valid, t), want)
        if t == 0.3:   # neighbours overlap by IoU 0.43: kept, suppressed...
            assert torch.equal(want[0], torch.arange(K) % 2 == 0)
