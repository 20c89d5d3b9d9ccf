"""The train step's remat branch (train/trainer.py::make_train_step(remat=,
remat_policy=)) against the port's plain step on the CPU, on the tiny AED
and batch of test_torch_port_train.py with the stem's dropout ON (rate
0.1, one seeded generator a step): the losses equal, the gradients within
1e-6 of each leaf's largest magnitude with the network in f64, the
BatchNorm running statistics equal, and each dropout mask of the
recompute equal to the forward's and to the plain step's, for full remat
(policy None) and for "dots". Without the replay of the dropout generator
the recompute draws new masks and the gradients move by hundreds, as
test_recompute_without_replay_draws_new_masks shows. The patchify step
and remat against JAX's are in test_torch_port_patchify_jax.py,
run_train's switches in test_torch_port_run_train.py.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.models.blocks import BatchNorm2d
from frlw_evd_tpu_torch.models.stems import Dropout
from frlw_evd_tpu_torch.train import TrainState, make_train_step, sgd
from frlw_evd_tpu_torch.train import trainer as trainer_mod

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    LR, NC, STATS, STRIDES, base, batch)


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

