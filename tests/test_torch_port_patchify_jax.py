"""The train step's patchify branch (train/trainer.py::make_train_step(
patchify=), make_eval_step(patchify=)) and its remat against the JAX
package's own patchify step on the CPU
(frlw_evd_tpu/train/trainer.py::make_train_step(patchify=True), stem
bfm_p64, dropout 0 on both sides, SGD 1e-2): in f32 the losses within
rtol 2e-4 and the running statistics within atol 1e-5; in f64 the
gradients (read from the SGD update, (p - p') / lr) within 1e-6 of each
leaf's largest magnitude, the gates of test_torch_port_train.py. Remat,
full and "dots", against JAX's remat step (make_train_step(remat=True,
remat_policy=..., patchify=True), jax.checkpoint with no policy or with
checkpoint_dots) on the same model in f64: the losses within rtol 2e-4,
the running statistics within atol 1e-5 and the gradients within 1e-6.
"""

from __future__ import annotations

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frlw_evd_tpu.models.darknet import Darknet
from frlw_evd_tpu.models.detector import EventDetector as JaxDetector
from frlw_evd_tpu.models.heads import YOLOXHead
from frlw_evd_tpu.models.pafpn import YOLOPAFPN
from frlw_evd_tpu.models.stems import BinsFusionModulePatched
from frlw_evd_tpu.train.trainer import TrainState as JTrainState
from frlw_evd_tpu.train.trainer import make_train_step as j_make_train_step
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.blocks import space_to_depth_patches
from frlw_evd_tpu_torch.train import (TrainState, make_eval_step,
                                      make_train_step, sgd)
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    C, H, LR, NARROW, NC, STATS, STRIDES, W, base, batch)


# -- patchify against JAX ---------------------------------------------------

def _jax_p64_model():
    return JaxDetector(
        backbone=Darknet(depth=21, stem=partial(BinsFusionModulePatched,
                                                dropout_rate=0.0),
                         stem_out_channels=16, out_channels=(32, 32, 32)),
        neck=YOLOPAFPN(depth=0.33, in_channels=(32, 32, 32)),
        head=YOLOXHead(num_classes=NC, strides=STRIDES, width=32))


@pytest.fixture(scope="module")
def p64_setup(batch):
    jm = _jax_p64_model()
    sample = jnp.zeros((1, H // 2, W // 2, 4 * C))
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(1), sample, False)
    return jm, jax.tree.map(np.array, variables)


def _jax_p64_step(jm, variables, imgs, labels, dtype, **kw):
    """JAX's make_train_step(patchify=True, **kw) with optax.sgd(LR), the
    state in `dtype`: (losses, gradients (p - p') / LR, state_dict
    after)."""
    with jax.enable_x64(dtype == np.float64):
        v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        tx = optax.sgd(LR)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=v["params"],
                            batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), tx=tx,
                            apply_fn=jm.apply)
        before = jax.tree.map(np.array, v["params"])   # the step donates
        step = j_make_train_step(STRIDES, NC, 2.5, patchify=True, **kw)
        new, losses = step(state, jnp.asarray(imgs.astype(dtype)),
                           jnp.asarray(labels), jax.random.key(3))
        grads = jax.tree.map(lambda a, b: (a - np.asarray(b)) / LR, before,
                             new.params)
        after = flax_to_state_dict({"params": new.params,
                                    "batch_stats": new.batch_stats})
        return ({k: float(x) for k, x in losses.items()},
                flax_to_state_dict({"params": grads}), after)


def _port_p64_step(variables, imgs, labels, dtype, **kw):
    model = load_flax_variables(
        build_detector(NC, stem="bfm_p64", train=True, dropout_rate=0.0,
                       **NARROW), variables).to(dtype)
    state = TrainState(0, model, sgd(LR).make(model.named_parameters()))
    losses = make_train_step(STRIDES, NC, 2.5, patchify=True, device="cpu",
                             **kw)(
        state, torch.from_numpy(imgs).to(dtype), torch.from_numpy(labels),
        torch.Generator())
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad for k, p in model.named_parameters()},
            model.state_dict())


def test_patchify_step_matches_jax_in_f32(p64_setup, batch):
    jm, variables = p64_setup
    imgs, labels = batch
    j_losses, _, j_after = _jax_p64_step(jm, variables, imgs, labels,
                                         np.float32)
    losses, _, after = _port_p64_step(variables, imgs, labels,
                                      torch.float32)
    assert losses.keys() == j_losses.keys()
    for k, v in losses.items():
        np.testing.assert_allclose(v, j_losses[k], rtol=2e-4, err_msg=k)
    stats = [k for k in j_after if k.endswith(STATS)]
    assert stats
    for k in stats:
        np.testing.assert_allclose(after[k].numpy(), j_after[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_patchify_gradients_match_jax_in_f64(p64_setup, batch):
    jm, variables = p64_setup
    imgs, labels = batch
    _, j_grads, _ = _jax_p64_step(jm, variables, imgs, labels, np.float64)
    _, grads, _ = _port_p64_step(variables, imgs, labels, torch.float64)
    assert grads.keys() == j_grads.keys()
    for k, g in grads.items():
        ref = j_grads[k].double().numpy()
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-12,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", [None, "dots"], ids=["full", "dots"])
def test_remat_step_matches_jax_remat_in_f64(p64_setup, batch, policy):
    jm, variables = p64_setup
    imgs, labels = batch
    kw = dict(remat=True, remat_policy=policy)
    j_losses, j_grads, j_after = _jax_p64_step(jm, variables, imgs, labels,
                                               np.float64, **kw)
    losses, grads, after = _port_p64_step(variables, imgs, labels,
                                          torch.float64, **kw)
    assert losses.keys() == j_losses.keys()
    for k, v in losses.items():
        np.testing.assert_allclose(v, j_losses[k], rtol=2e-4, err_msg=k)
    stats = [k for k in j_after if k.endswith(STATS)]
    assert stats
    for k in stats:
        np.testing.assert_allclose(after[k].numpy(), j_after[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert grads.keys() == j_grads.keys()
    for k, g in grads.items():
        ref = j_grads[k].double().numpy()
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-12,
                                   rtol=0, err_msg=k)


def test_patchify_eval_step_equals_canonical(base, batch):
    """make_eval_step(patchify=True) with the bfm_p64 stem gives the
    canonical bfm model's detections on the same weights."""
    imgs = torch.from_numpy(batch[0])
    p64 = build_detector(NC, stem="bfm_p64", **NARROW)
    p64.load_state_dict(base.state_dict())
    canon = copy.deepcopy(base).eval()
    got = make_eval_step(STRIDES, patchify=True, device="cpu")(
        TrainState(0, p64, None), imgs)
    want = make_eval_step(STRIDES, device="cpu")(
        TrainState(0, canon, None), imgs)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0][got[1]], want[0][want[1]], rtol=1e-4,
                               atol=1e-3)
    assert space_to_depth_patches(imgs).shape == (4, H // 2, W // 2, 4 * C)

