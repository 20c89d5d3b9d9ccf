"""The train step's remat and patchify branches (train/trainer.py::
make_train_step(remat=, remat_policy=, patchify=), make_eval_step(patchify=)
and train/synthetic.run_train's switches) on the CPU.

Remat against the port's plain step, on the tiny AED and batch of
test_torch_port_train.py with the stem's dropout ON (rate 0.1, one seeded
generator a step): the losses equal, the gradients within 1e-6 of each
leaf's largest magnitude with the network in f64, the BatchNorm running
statistics equal, and each dropout mask of the recompute equal to the
forward's and to the plain step's, for full remat (policy None) and for
"dots". Without the replay of the dropout generator the recompute draws
new masks and the gradients move by hundreds, as
test_recompute_without_replay_draws_new_masks shows.

Patchify against the JAX package's own patchify step
(frlw_evd_tpu/train/trainer.py::make_train_step(patchify=True), stem
bfm_p64, dropout 0 on both sides, SGD 1e-2): in f32 the losses within rtol
2e-4 and the running statistics within atol 1e-5; in f64 the gradients
(read from the SGD update, (p - p') / lr) within 1e-6 of each leaf's
largest magnitude, the gates of test_torch_port_train.py. Remat, full and
"dots", against JAX's remat step (make_train_step(remat=True,
remat_policy=..., patchify=True), jax.checkpoint with no policy or with
checkpoint_dots) on the same model in f64: the losses within rtol 2e-4,
the running statistics within atol 1e-5 and the gradients within 1e-6.
"""

from __future__ import annotations

import contextlib
import copy
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
from frlw_evd_tpu.models.heads import YOLOXHead
from frlw_evd_tpu.models.pafpn import YOLOPAFPN
from frlw_evd_tpu.models.stems import BinsFusionModulePatched
from frlw_evd_tpu.train.trainer import TrainState as JTrainState
from frlw_evd_tpu.train.trainer import make_train_step as j_make_train_step
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.blocks import (BatchNorm2d,
                                              space_to_depth_patches)
from frlw_evd_tpu_torch.models.stems import Dropout
from frlw_evd_tpu_torch.train import (TrainState, make_eval_step,
                                      make_train_step, run_train, sgd)
from frlw_evd_tpu_torch.train import trainer as trainer_mod
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import small_train_batch  # noqa: E402

H, W, C, NC = 64, 96, 16, 2
STRIDES = (8, 16, 32)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
STATS = ("running_mean", "running_var")
LR = 1e-2


@pytest.fixture(scope="module")
def batch():
    return small_train_batch(np.random.default_rng(0))


@pytest.fixture(scope="module")
def base():
    """The tiny AED with dropout 0.1, weights from torch seed 0."""
    return build_detector(NC, stem="bfm", train=True, dropout_rate=0.1,
                          generator=torch.Generator().manual_seed(0),
                          **NARROW)


def _step(base, batch, dtype, **kw):
    """One SGD step of a copy of `base` in `dtype`; records every dropout
    output's zero mask and counts the BatchNorm forwards."""
    model = copy.deepcopy(base).to(dtype)
    masks, bn_calls = [], [0]
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.register_forward_hook(
                lambda m, i, o: masks.append((o == 0).clone()))
        elif isinstance(mod, BatchNorm2d):
            mod.register_forward_hook(
                lambda m, i, o: bn_calls.__setitem__(0, bn_calls[0] + 1))
    state = TrainState(0, model, sgd(LR).make(model.named_parameters()))
    imgs, labels = batch
    losses = make_train_step(STRIDES, NC, 2.5, device="cpu", **kw)(
        state, torch.from_numpy(imgs).to(dtype), torch.from_numpy(labels),
        torch.Generator().manual_seed(7))
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={k: p.grad.clone() for k, p in model.named_parameters()},
                stats={k: v.clone() for k, v in model.state_dict().items()
                       if k.endswith(STATS)},
                masks=masks, bn_calls=bn_calls[0])


@pytest.fixture(scope="module")
def plain_steps(base, batch):
    return {dtype: _step(base, batch, dtype)
            for dtype in (torch.float32, torch.float64)}


@pytest.mark.parametrize("policy", [None, "dots"], ids=["full", "dots"])
def test_remat_step_equals_plain_step(base, batch, plain_steps, policy):
    want = plain_steps[torch.float32]
    got = _step(base, batch, torch.float32, remat=True, remat_policy=policy)
    assert got["losses"] == want["losses"]
    assert got["stats"].keys() == want["stats"].keys()
    for k, v in want["stats"].items():
        torch.testing.assert_close(got["stats"][k], v, rtol=0, atol=0,
                                   msg=k)
    # the recompute ran BatchNorm again without updating its statistics
    assert got["bn_calls"] > want["bn_calls"]


@pytest.mark.parametrize("policy", [None, "dots"], ids=["full", "dots"])
def test_remat_gradients_match_plain_in_f64(base, batch, plain_steps,
                                            policy):
    want = plain_steps[torch.float64]["grads"]
    got = _step(base, batch, torch.float64, remat=True,
                remat_policy=policy)["grads"]
    assert got.keys() == want.keys()
    for k, g in got.items():
        ref = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-12,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("policy", [None, "dots"], ids=["full", "dots"])
def test_remat_recompute_reuses_dropout_masks(base, batch, plain_steps,
                                              policy):
    want = plain_steps[torch.float32]["masks"]
    got = _step(base, batch, torch.float32, remat=True,
                remat_policy=policy)["masks"]
    # the forward's masks, then the recompute's: both the plain step's
    assert len(want) == 2 and len(got) == 2 * len(want)
    for i, mask in enumerate(got):
        assert torch.equal(mask, want[i % len(want)]), i
    assert 0 < want[0].float().mean() < 0.2


def test_recompute_without_replay_draws_new_masks(base, batch, plain_steps,
                                                  monkeypatch):
    """The trap the replay closes: checkpoint's preserve_rng_state does
    not cover the stem's own torch.Generator, so a recompute that does not
    set its state back draws new masks and the gradients are wrong."""
    @contextlib.contextmanager
    def no_replay(inner, model, generator, forward_state):
        with trainer_mod._stats_frozen(model), inner:
            yield

    monkeypatch.setattr(trainer_mod, "_replay", no_replay)
    got = _step(base, batch, torch.float64, remat=True)
    want = plain_steps[torch.float64]
    assert not torch.equal(got["masks"][2], got["masks"][0])
    worst = max((got["grads"][k] - g).abs().max().item()
                for k, g in want["grads"].items())
    assert worst > 1.0


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        make_train_step(STRIDES, NC, 2.5, remat=True, remat_policy="all",
                        device="cpu")


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


def test_run_train_switches():
    """run_train's remat / p64 switches (bench.py:460-490) at a tiny size,
    bf16 over f32 masters as the bench runs: the remat ways' first steps
    give their plain ways' losses, p64 its own (its stem's bf16 sums run
    in another order; the f32 and f64 tests above hold its math)."""
    cfg = dict(input_hw=(H, W), batch=2, num_classes=NC)

    def first_losses(stem, **kw):
        model = build_detector(NC, stem=stem, train=True, dropout_rate=0.1,
                               generator=torch.Generator().manual_seed(2),
                               **NARROW)
        out = run_train(cfg, steps=1, warmup=1, model=model, device="cpu",
                        **kw)
        assert all(np.isfinite(list(lo.values())).all()
                   for lo in out["losses"])
        return out["losses"][0]

    assert first_losses("bfm", remat=True) == first_losses("bfm")
    p64 = first_losses("bfm_p64", p64=True)
    assert first_losses("bfm_p64", p64=True, remat=True,
                        remat_policy="dots") == p64
