"""The port's bf16 train step against the JAX package's, and a checkpoint
round trip, on the CPU.

The tiny AED of test_torch_port_train.py with the stem's dropout at 0,
from the same JAX init on both sides. half_precision: both run the network
on bf16 copies of f32 masters and update the masters with Adam(1e-3), two
steps on the same batch.
  * Each step's total loss within rel 5e-2 of JAX's (the gate of
    tests/test_train.py:238-240: bf16 rounds at other places in the two
    frameworks); the masters and statistics f32 after.
  * BatchNorm running statistics, layer by layer: each BatchNorm's input
    in the port's second step (bf16) goes through the JAX package's
    SpmdBatchNorm with the statistics from before that step; the port's
    statistics after it equal flax's within atol 1e-5. An unbiased running
    variance (0.1 * var / (n - 1) larger, n = 24 values a channel at the
    coarsest level) or statistics rounded to bf16 (2^-9 of their size)
    miss that gate many times over; the test checks that they would.
  * The statistics after the first step against JAX's after its first
    (after the second, Adam's first updates, about lr on every weight
    whatever its gradient's size, have turned the gradients' rounding
    into different weights): atol 3e-2 only. The two frameworks' bf16
    activations round apart and drift through the network; JAX's bf16
    statistics differ from its own f32 step's by about 1e-2 here.
The eval step is in test_torch_port_train_eval.py.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frlw_evd_tpu.models.blocks import SpmdBatchNorm
from frlw_evd_tpu.train.trainer import \
    create_train_state as jax_create_train_state
from frlw_evd_tpu.train.trainer import make_train_step as jax_make_train_step
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.blocks import BatchNorm2d
from frlw_evd_tpu_torch.train import (adam, create_train_state, ema_init,
                                      ema_update, load_checkpoint,
                                      make_train_step, save_checkpoint,
                                      yolox_warm_cos_schedule)
from frlw_evd_tpu_torch.weights import flax_to_state_dict
from test_torch_port_train import (C, H, NC, STRIDES, W, jax_model,
                                   port_model, small_train_batch)

STATS = ("running_mean", "running_var")


def _record_batchnorms(model):
    """Hooks that keep, for each BatchNorm, its last call: the input, the
    scale and bias it ran with (the compute copies), its running
    statistics before the call and its output."""
    calls = {}

    def hooks(name):
        def before(mod, args):
            calls[name] = dict(zip(("x", "scale", "bias", "mean", "var"), (
                t.detach().clone() for t in (args[0], mod.weight, mod.bias,
                                             mod.running_mean,
                                             mod.running_var))))

        def after(mod, args, out):
            calls[name]["out"] = out.detach().clone()
        return before, after

    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            before, after = hooks(name)
            mod.register_forward_pre_hook(before)
            mod.register_forward_hook(after)
    return calls


def _flax_batchnorm(call, train):
    """The JAX package's SpmdBatchNorm on a recorded call: (output, updated
    batch_stats)."""
    bn = SpmdBatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    y, upd = bn.apply({"params": {"scale": _jnp(call["scale"]),
                                  "bias": _jnp(call["bias"])},
                       "batch_stats": {"mean": _jnp(call["mean"]),
                                       "var": _jnp(call["var"])}},
                      _jnp(call["x"].permute(0, 2, 3, 1)),
                      mutable=["batch_stats"])
    return y, upd["batch_stats"]


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.fixture(scope="module")
def bf16_steps():
    imgs, labels = small_train_batch(np.random.default_rng(0))
    jm = jax_model()
    state = jax_create_train_state(jm, jax.random.key(1),
                                   jnp.zeros((1, H, W, C)), optax.adam(1e-3))
    variables = {"params": jax.tree.map(np.array, state.params),
                 "batch_stats": jax.tree.map(np.array, state.batch_stats)}
    j_step = jax_make_train_step(STRIDES, NC, 2.5, half_precision=True)
    model = port_model(variables)
    bn_calls = _record_batchnorms(model)
    t_state = create_train_state(model, adam(1e-3), device="cpu")
    t_step = make_train_step(STRIDES, NC, 2.5, half_precision=True,
                             device="cpu")
    args = (jnp.asarray(imgs), jnp.asarray(labels), jax.random.key(2))
    losses, after_one = [], None
    for _ in range(2):
        state, j_losses = j_step(state, *args)
        t_losses = t_step(t_state, torch.from_numpy(imgs),
                          torch.from_numpy(labels), torch.Generator())
        losses.append((t_losses["total_loss"].item(),
                       float(j_losses["total_loss"])))
        if after_one is None:
            after_one = dict(j_stats=jax.tree.map(np.array,
                                                  state.batch_stats),
                             stats={k: v.clone() for k, v in
                                    model.state_dict().items()
                                    if k.endswith(STATS)})
    return dict(t_state=t_state, losses=losses, bn_calls=bn_calls,
                **after_one)


def test_bf16_step_tracks_jax(bf16_steps):
    for i, (got, want) in enumerate(bf16_steps["losses"]):
        assert np.isfinite(want)
        assert got == pytest.approx(want, rel=5e-2), i
    state = bf16_steps["t_state"]
    assert state.step == 2
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for b in state.model.buffers()
               if b.is_floating_point())


def test_bf16_running_statistics_match_flax(bf16_steps):
    model = bf16_steps["t_state"].model
    calls = bf16_steps["bn_calls"]
    assert len(calls) == sum(isinstance(m, BatchNorm2d)
                             for m in model.modules())
    unbiased_shift = bf16_shift = 0.0
    for name, call in calls.items():
        assert call["x"].dtype == call["scale"].dtype == torch.bfloat16, name
        assert call["mean"].dtype == torch.float32, name
        _, want = _flax_batchnorm(call, train=True)
        mod = model.get_submodule(name)
        want_var = np.asarray(want["var"])
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(want["mean"]), atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(mod.running_var.numpy(), want_var,
                                   atol=1e-5, rtol=0, err_msg=name)
        n = call["x"].numel() // call["x"].shape[1]
        batch_var = (want_var - 0.9 * call["var"].numpy()) / 0.1
        unbiased_shift = max(unbiased_shift,
                             float((0.1 * batch_var / (n - 1)).max()))
        bf16_shift = max(bf16_shift, float(
            (mod.running_var.bfloat16().float() - mod.running_var)
            .abs().max()))
    assert unbiased_shift > 1e-3 and bf16_shift > 1e-3, (unbiased_shift,
                                                          bf16_shift)


def test_bf16_running_statistics_track_jax(bf16_steps):
    sd = bf16_steps["stats"]
    want = flax_to_state_dict({"batch_stats": bf16_steps["j_stats"]})
    assert set(want) == set(sd)
    for k, v in want.items():
        assert not torch.equal(sd[k], torch.ones_like(sd[k])), k
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=3e-2,
                                   rtol=0, err_msg=k)


NARROW = dict(in_channels=(16, 16, 16), stem_out_channels=8, head_width=16)


def _fresh_state(seed):
    model = build_detector(NC, stem="bfm", train=True,
                           generator=torch.Generator().manual_seed(seed),
                           **NARROW)
    sched = yolox_warm_cos_schedule(1e-3, 0.05, total_iters=20,
                                    warmup_total_iters=3)
    return create_train_state(model, adam(sched), device="cpu")


def test_checkpoint_round_trip_resumes_bitwise(tmp_path):
    """Save after one step (dropout on), load into a differently seeded
    model, then the next step on both is bitwise equal: losses, masters,
    running statistics and Adam's moments."""
    data = [[torch.from_numpy(a) for a in
             small_train_batch(np.random.default_rng(s))] for s in (0, 1)]
    step = make_train_step(STRIDES, NC, 2.5, device="cpu")
    a = _fresh_state(0)
    step(a, *data[0], torch.Generator().manual_seed(1))
    ema_a = ema_init(dict(a.model.named_parameters()))
    ema_update(ema_a, dict(a.model.named_parameters()), a.step)
    path = str(tmp_path / "ckpt" / "last.pth")
    save_checkpoint(path, a, epoch=3, max_score=0.25, ema=ema_a)
    assert os.listdir(tmp_path / "ckpt") == ["last.pth"]

    b = _fresh_state(7)
    ema_b = ema_init(dict(b.model.named_parameters()))
    b, epoch, score = load_checkpoint(path, b, ema=ema_b)
    assert (epoch, score, b.step) == (4, 0.25, 1)
    for k in ema_a:
        assert torch.equal(ema_a[k], ema_b[k]), k

    la = step(a, *data[1], torch.Generator().manual_seed(2))
    lb = step(b, *data[1], torch.Generator().manual_seed(2))
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    assert [g["lr"] for g in a.optimizer.param_groups] == \
        [g["lr"] for g in b.optimizer.param_groups]
