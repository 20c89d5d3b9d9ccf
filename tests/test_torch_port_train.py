"""The port's train step against the JAX package's on the CPU.

The tiny AED of tests/test_train_p64.py (64x96x16 input, batch 4, 10 label
rows, pyramid 32 wide, stem 16, head 32; the batch is chip_smoke.py's
small_train_batch, which its phase 19 runs on the card) with the stem's
dropout at 0 on both sides; the JAX variables go across with
weights.load_flax_variables
and the gradient tree back through flax_to_state_dict. One step with
SGD(1e-2) on the same batch, on each side.

In f32: the losses within rtol 2e-4 (the gate of test_train_p64.py) and
the BatchNorm running statistics within atol 1e-5, which an unbiased
running variance (n / (n - 1) larger, n = 4 * 2 * 3 = 24 at the coarsest
level) misses; the masters stay f32.

With the network in f64 on both sides (the head maps still cast to f32
for the loss, as both steps do): each gradient leaf within 1e-6 of its
largest magnitude and the parameters after the SGD step within atol 1e-6
(test_train_p64.py allows 3e-4). In f32 the order of the convolutions'
sums alone moves the stem's weight-norm gradients by about 1e-4 of their
size (0.02 of 331 between the port in f32 and in f64), which the SGD step
turns into 5e-4 on weight_v, whose update is 3000 times its size; f64
takes that noise out, so the gates test the algorithm.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frlw_evd_tpu.models.darknet import Darknet
from frlw_evd_tpu.models.detector import EventDetector as JaxDetector
from frlw_evd_tpu.models.detector import detector_loss as jax_detector_loss
from frlw_evd_tpu.models.heads import YOLOXHead
from frlw_evd_tpu.models.pafpn import YOLOPAFPN
from frlw_evd_tpu.models.stems import BinsFusionModule
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.train import (TrainState, create_train_state,
                                      make_train_step, sgd)
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import small_train_batch  # noqa: E402  (the step's batch)

H, W, C, NC = 64, 96, 16, 2
STRIDES = (8, 16, 32)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
STATS = ("running_mean", "running_var")


def jax_model():
    return JaxDetector(
        backbone=Darknet(depth=21, stem=partial(BinsFusionModule,
                                                dropout_rate=0.0),
                         stem_out_channels=16, out_channels=(32, 32, 32)),
        neck=YOLOPAFPN(depth=0.33, in_channels=(32, 32, 32)),
        head=YOLOXHead(num_classes=NC, strides=STRIDES, width=32))


def port_model(variables, **kw):
    model = build_detector(NC, stem="bfm", train=True, dropout_rate=0.0,
                           **NARROW, **kw)
    return load_flax_variables(model, variables)


@pytest.fixture(scope="module")
def setup():
    imgs, labels = small_train_batch(np.random.default_rng(0))
    jm = jax_model()
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(1), jnp.zeros((1, H, W, C)), False)
    return jm, jax.tree.map(np.array, variables), imgs, labels


def jax_sgd_step(jm, variables, imgs, labels):
    """JAX's step: value_and_grad of detector_loss on the head maps cast
    to f32 (trainer.py:259-278), then optax.sgd(1e-2)."""
    def loss_fn(params):
        outs, upd = jm.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(imgs), True, mutable=["batch_stats"])
        losses = jax_detector_loss([o.astype(jnp.float32) for o in outs],
                                   jnp.asarray(labels), STRIDES, NC, 2.5)
        return losses["total_loss"], (losses, upd["batch_stats"])
    (_, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tx = optax.sgd(1e-2)
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    return dict(losses=losses, grads=flax_to_state_dict({"params": grads}),
                after=flax_to_state_dict({"params": params,
                                          "batch_stats": stats}))


def port_sgd_step(state, imgs, labels):
    step = make_train_step(STRIDES, NC, 2.5, device="cpu")
    dtype = next(state.model.parameters()).dtype
    losses = step(state, torch.from_numpy(imgs).to(dtype),
                  torch.from_numpy(labels), torch.Generator())
    return dict(losses=losses, model=state.model,
                grads={k: p.grad for k, p in state.model.named_parameters()})


@pytest.fixture(scope="module")
def f32_steps(setup):
    jm, variables, imgs, labels = setup
    model = port_model(variables)
    state = create_train_state(model, sgd(1e-2), device="cpu")
    return (port_sgd_step(state, imgs, labels),
            jax_sgd_step(jm, variables, imgs, labels),
            flax_to_state_dict(variables))


@pytest.fixture(scope="module")
def f64_steps(setup):
    jm, variables, imgs, labels = setup
    model = port_model(variables).double()
    state = TrainState(0, model, sgd(1e-2).make(model.named_parameters()))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want = jax_sgd_step(jm, v64, imgs.astype(np.float64), labels)
    return port_sgd_step(state, imgs, labels), want


def test_f32_losses_match_jax(f32_steps):
    got, want, _ = f32_steps
    assert set(got["losses"]) == set(want["losses"])
    for k, v in got["losses"].items():
        np.testing.assert_allclose(v.item(), float(want["losses"][k]),
                                   rtol=2e-4, err_msg=k)


def test_f32_running_statistics_match_jax(f32_steps):
    got, want, before = f32_steps
    sd = got["model"].state_dict()
    stats = [k for k in want["after"] if k.endswith(STATS)]
    assert len(stats) == 2 * sum(k.endswith(".bn.weight") for k in sd)
    for k in stats:
        assert not torch.equal(sd[k], before[k]), k
        np.testing.assert_allclose(sd[k].numpy(), want["after"][k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_f32_masters_stay_f32_and_move(f32_steps):
    got, _, before = f32_steps
    for k, p in got["model"].named_parameters():
        assert p.dtype == torch.float32, k
        if got["grads"][k].abs().sum() > 0:
            assert not torch.equal(p.detach(), before[k]), k


def test_gradients_match_jax_leaf_by_leaf(f64_steps):
    got, want = f64_steps
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        ref = want["grads"][k].double().numpy()
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-12,
                                   rtol=0, err_msg=k)


def test_sgd_step_matches_jax(f64_steps):
    got, want = f64_steps
    sd = got["model"].state_dict()
    for k, ref in want["after"].items():
        tol = 1e-5 if k.endswith(STATS) else 1e-6
        np.testing.assert_allclose(sd[k].numpy(), ref.double().numpy(),
                                   atol=tol, rtol=0, err_msg=k)
