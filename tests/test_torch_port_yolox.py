"""The yolox family of the port (models/blocks.DWConv, the depthwise
Bottleneck and CSPLayer, models/darknet.CSPDarknet, build_detector's
family "yolox") against the JAX package's on the CPU.

Weights go across with weights.load_flax_variables from JAX's init, with
BatchNorm statistics, affines and biases randomised first
(test_torch_port_detector.randomize_variables); a flax depthwise kernel
(k, k, 1, C) reaches torch as (C, 1, k, k) through flax_to_state_dict's
one HWIO → OIHW transpose. Gates: the f32 forwards within 2e-4 (the
torch-import parity gate); one SGD train step of the yolox detector in
f64 (dropout 0 on both sides) with the losses within rtol 1e-6 and the
BatchNorm running statistics within atol 1e-5; and make_pipeline_kernel
serving a yolox_taf_bfm model at a mini GEN1 geometry with the states bit
for bit, the volumes within 2e-2, the keep masks equal and the kept boxes
within rtol 1e-4 + atol 1e-3 of bench.make_pipeline_kernel's with the
flax model (test_torch_port_pipeline.py's gates and event times).
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models.blocks import DWConv as JDWConv
from frlw_evd_tpu.models.blocks import Focus as JFocus
from frlw_evd_tpu.models.darknet import CSPDarknet as JCSPDarknet
from frlw_evd_tpu.models.detector import detector_loss as jax_detector_loss
from frlw_evd_tpu.models.detector import eval_decode as jax_eval_decode
from frlw_evd_tpu.models.postprocess import \
    postprocess_batch as jax_postprocess
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.blocks import DWConv, Focus
from frlw_evd_tpu_torch.models.darknet import CSPDarknet
from frlw_evd_tpu_torch.train import TrainState, make_train_step, sgd
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from test_torch_port_detector import randomize_variables
from test_torch_port_pipeline import _windows

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
from chip_smoke import small_train_batch  # noqa: E402

H, W, NC = 64, 96, 2
STRIDES = (8, 16, 32)
FWD_TOL = 2e-4
STATS = ("running_mean", "running_var")


def _init(module, x, *args):
    variables = jax.jit(module.init, static_argnums=tuple(
        range(2, 2 + len(args))))(jax.random.key(0), x, *args)
    return randomize_variables(variables, np.random.default_rng(0))


def test_dwconv_matches_flax_and_carries_the_depthwise_kernel():
    x = np.random.default_rng(1).normal(size=(2, 12, 16, 8)).astype(
        np.float32)
    jm = JDWConv(24, 3, 2)
    variables = _init(jm, jnp.asarray(x), False)
    kernel = variables["params"]["dconv"]["conv"]["kernel"]
    assert kernel.shape == (3, 3, 1, 8)
    sd = flax_to_state_dict(variables)
    np.testing.assert_array_equal(sd["dconv.conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    tm = load_flax_variables(DWConv(8, 24, 3, 2), variables).eval()
    assert tm.dconv.conv.weight.shape == (8, 1, 3, 3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("depthwise", [False, True],
                         ids=["dense", "depthwise"])
def test_csp_darknet_matches_flax(depthwise):
    """CSPDarknet at dep_mul 0.33 (CSP depths 1, 3, 3, 1) and wid_mul 0.25
    (16 to 256 channels), Focus stem over 10 channels: the pyramid."""
    x = np.random.default_rng(2).uniform(0, 1, (2, H, W, 10)).astype(
        np.float32)
    jm = JCSPDarknet(dep_mul=0.33, wid_mul=0.25, stem=JFocus,
                     depthwise=depthwise)
    variables = _init(jm, jnp.asarray(x), False)
    tm = load_flax_variables(
        CSPDarknet(Focus, 10, dep_mul=0.33, wid_mul=0.25,
                   depthwise=depthwise), variables).eval()
    want = jm.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for lvl, (g, j) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == j.shape == (2, H // STRIDES[lvl],
                                      W // STRIDES[lvl], 64 * 2 ** lvl)
        np.testing.assert_allclose(g, np.asarray(j), atol=FWD_TOL, rtol=0,
                                   err_msg=f"level {lvl}")


@pytest.fixture(scope="module")
def yolox_pair():
    """(flax yolox detector, its randomised variables, the port's on
    them), stem bfm without dropout, head 32 wide, 16 input channels."""
    jm = jax_build(NC, family="yolox", stem="bfm", head_width=32)
    jm = jm.clone(backbone=jm.backbone.clone(
        stem=partial(jm.backbone.stem, dropout_rate=0.0)))
    variables = _init(jm, jnp.zeros((1, H, W, 16)), False)
    tm = build_detector(NC, family="yolox", stem="bfm", head_width=32,
                        dropout_rate=0.0)
    return jm, variables, load_flax_variables(tm, variables)


def test_yolox_detector_matches_flax(yolox_pair):
    jm, variables, tm = yolox_pair
    x = np.random.default_rng(3).uniform(0, 1, (2, H, W, 16)).astype(
        np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx, False))(variables,
                                                        jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    for lvl, (g, j) in enumerate(zip(got, want)):
        assert g.shape == j.shape == (2, H // STRIDES[lvl],
                                      W // STRIDES[lvl], 4 + 1 + NC)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=FWD_TOL,
                                   rtol=0, err_msg=f"level {lvl}")


def test_yolox_train_step_matches_jax(yolox_pair):
    """One SGD(1e-2) step on chip_smoke's small batch, the network in f64
    on both sides (the head maps cast to f32 for the loss, as both steps
    do): the losses within rtol 1e-6 and the BatchNorm running statistics
    within atol 1e-5 of JAX's step (trainer.py:259-278). In f32 the order
    of the convolutions' sums alone moves this cls_loss by about 1e-4 of
    itself (2.2e-4 seen on these weights, 7e-8 in f64)."""
    jm, variables, _ = yolox_pair
    imgs, labels = small_train_batch(np.random.default_rng(0))
    imgs = imgs.astype(np.float64)

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params):
            outs, upd = jm.apply({"params": params,
                                  "batch_stats": v64["batch_stats"]},
                                 jnp.asarray(imgs), True,
                                 mutable=["batch_stats"])
            losses = jax_detector_loss([o.astype(jnp.float32) for o in outs],
                                       jnp.asarray(labels), STRIDES, NC, 2.5)
            return losses["total_loss"], (losses, upd["batch_stats"])

        (_, (j_losses, j_stats)), _ = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v64["params"])
        j_losses = {k: float(v) for k, v in j_losses.items()}
        j_stats = {k: v.double() for k, v in flax_to_state_dict(
            {"batch_stats": j_stats}).items()}

    tm = load_flax_variables(
        build_detector(NC, family="yolox", stem="bfm", head_width=32,
                       dropout_rate=0.0, train=True), variables).double()
    state = TrainState(0, tm, sgd(1e-2).make(tm.named_parameters()))
    losses = make_train_step(STRIDES, NC, 2.5, device="cpu")(
        state, torch.from_numpy(imgs), torch.from_numpy(labels),
        torch.Generator())
    assert set(losses) == set(j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), j_losses[k], rtol=1e-6,
                                   err_msg=k)
    sd = tm.state_dict()
    stats = [k for k in sd if k.endswith(STATS)]
    assert stats and set(stats) == set(j_stats)
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), j_stats[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def _serving_variables(jm, sample):
    """JAX init with the BatchNorm affines spread (scale U(1, 1.25), bias
    N(0, 0.1), as test_torch_port_trainer._serving_params: the AED
    pipeline test's U(1, 2) compounds over the yolox net's 71 BatchNorms
    into box sizes of 4e4 px) and the obj biases raised."""
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(0), sample, False)
    rng = np.random.default_rng(0)
    flat = {}
    for path, a in flatten_dict(variables["params"]).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 1.25, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = 2.0
        flat[path] = a
    return {"params": unflatten_dict(flat),
            "batch_stats": jax.tree.map(lambda a: np.array(a, np.float32),
                                        variables["batch_stats"])}


def test_yolox_serving_slice_matches_jax_pipeline():
    """make_pipeline_kernel takes the yolox_taf_bfm model as it takes the
    AED: three windows carrying state against bench.make_pipeline_kernel
    with the flax yolox detector, f32 on both sides."""
    sensor, inp, batch = (60, 72), (64, 96), 2
    jm = jax_build(NC, family="yolox", stem="bfm", head_width=32)
    variables = _serving_variables(jm, jnp.zeros((1, *inp, 16)))
    j_enc = bench.make_pipeline_kernel(jm, variables, sensor, inp,
                                       scatter="pallas"
                                       ).stages["encode_transform"]
    j_apply = jax.jit(lambda v, x: jm.apply(v, x, False))
    tm = load_flax_variables(
        build_detector(NC, family="yolox", stem="bfm", head_width=32),
        variables)
    run = pipeline.make_pipeline_kernel(tm, sensor, inp, device="cpu",
                                        dtype=torch.float32)
    enc, detect = run.stages["encode_transform"], run.stages["detect"]
    state = pipeline.new_state(batch, sensor, device="cpu")
    j_state = jnp.full((batch, sensor[0], sensor[1] * 16), -6000.0,
                       jnp.float32)
    n_kept = 0
    for i, (ev, nv) in enumerate(_windows()):
        state, vol = enc(state, torch.from_numpy(ev), torch.from_numpy(nv))
        j_state, j_vol = j_enc(j_state, jnp.asarray(ev), jnp.asarray(nv))
        np.testing.assert_array_equal(state.numpy(), np.asarray(j_state),
                                      err_msg=f"state, window {i}")
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        dets, keep = detect(vol)
        j_outs = [o.astype(jnp.float32)
                  for o in j_apply(variables, j_vol.astype(jnp.float32))]
        j_dets, j_keep = jax_postprocess(
            jax_eval_decode(j_outs, pipeline.STRIDES), max_detections=100)
        j_keep = np.asarray(j_keep)
        np.testing.assert_array_equal(keep.numpy(), j_keep,
                                      err_msg=f"keep, window {i}")
        np.testing.assert_allclose(dets.numpy()[j_keep],
                                   np.asarray(j_dets)[j_keep], rtol=1e-4,
                                   atol=1e-3, err_msg=f"dets, window {i}")
        n_kept += int(j_keep.sum())
    assert n_kept > 0
