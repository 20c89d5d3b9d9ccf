"""Parts of the port's training slice against the JAX package on the CPU:
SimOTA, the losses, BatchNorm's training statistics, the optimiser with the
yolox schedule, the schedules, the EMA, the stem's dropout, the config,
and the refusals (kernel stems in training, no card without device="cpu").

Tolerances: the assignment matches exactly (fg_mask, matched_gt and
matched_cls on the foreground, the counts), pred_iou within 1e-6; losses
rtol 2e-4 and their gradients atol 1e-6 (f32 sums in another order);
running statistics atol 1e-6 (n = 12 values a channel, so torch's
unbiased running variance would be off by 1/11); Adam against optax atol
1e-6 over 3 steps on the same gradients; schedules and EMA rtol 1e-6 (JAX
evaluates them in f32, the port in f64).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frlw_evd_tpu.models.assign import simota_assign as jax_simota
from frlw_evd_tpu.models.blocks import SpmdBatchNorm
from frlw_evd_tpu.models.detector import detector_loss as jax_detector_loss
from frlw_evd_tpu.models.heads import level_grids as jax_level_grids
from frlw_evd_tpu.train import config as jax_config
from frlw_evd_tpu.train import ema as jax_ema
from frlw_evd_tpu.train import schedule as jax_schedule
from frlw_evd_tpu_torch.models import build_detector, detector_loss
from frlw_evd_tpu_torch.models.assign import (get_geometry_constraints,
                                              simota_assign)
from frlw_evd_tpu_torch.models.blocks import BatchNorm2d
from frlw_evd_tpu_torch.models.stems import (BinsFusionModuleFolded,
                                             BinsFusionModulePatchedKernel,
                                             Dropout)
from frlw_evd_tpu_torch.train import (adam, config, create_train_state,
                                      ema_update, make_eval_step,
                                      make_train_step, run_train, schedule,
                                      sgd, synthetic_batches)

H, W, NC = 64, 96, 2
STRIDES = (8, 16, 32)
HW = [(H // s, W // s) for s in STRIDES]
NARROW = dict(in_channels=(16, 16, 16), stem_out_channels=8, head_width=16)


def _anchors():
    xs, ys, ss = jax_level_grids(HW, STRIDES)
    return (xs + 0.5) * ss, (ys + 0.5) * ss, ss


def _simota_inputs(rng):
    """Three images, ten gt rows each: (0) random predictions, three gts,
    one of them off the image's corner with 5 candidate anchors; (1) no
    gt; (2) every prediction the same box and logits, and two identical
    gts, so that costs tie exactly across anchors and across gts."""
    A = sum(h * w for h, w in HW)
    N, G = 3, 10
    gt = np.zeros((N, G, 4), np.float32)
    cls = np.zeros((N, G), np.int64)
    valid = np.zeros((N, G), bool)
    gt[0, :3] = [[40, 30, 30, 20], [70, 40, 20, 30], [-30, -30, 8, 8]]
    cls[0, :3] = [1, 0, 1]
    gt[2, :2] = [[48, 32, 40, 30], [48, 32, 40, 30]]
    cls[2, :2] = [1, 1]
    valid[0, :3] = valid[2, :2] = True
    preds = np.concatenate([rng.uniform(0, 96, (N, A, 2)),
                            rng.uniform(4, 40, (N, A, 2))], -1)
    obj = rng.normal(0, 2, (N, A))
    logits = rng.normal(0, 2, (N, A, NC))
    preds[2], obj[2], logits[2] = [46, 31, 30, 24], 0.5, [-0.3, 0.8]
    return gt, cls, valid, preds.astype(np.float32), \
        obj.astype(np.float32), logits.astype(np.float32)


def test_simota_matches_jax(rng):
    gt, cls, valid, preds, obj, logits = _simota_inputs(rng)
    xc, yc, ss = _anchors()
    got = simota_assign(*(torch.from_numpy(a) for a in
                          (gt, cls, valid, preds, obj, logits, xc, yc, ss)),
                        2.5, num_classes=NC)
    for n in range(gt.shape[0]):
        want = jax_simota(*(jnp.asarray(a) for a in
                            (gt[n], cls[n].astype(np.int32), valid[n],
                             preds[n], obj[n], logits[n], xc, yc, ss)),
                          2.5, num_classes=NC)
        fg = np.asarray(want.fg_mask)
        np.testing.assert_array_equal(got.fg_mask[n].numpy(), fg)
        np.testing.assert_array_equal(got.matched_gt[n].numpy()[fg],
                                      np.asarray(want.matched_gt)[fg])
        np.testing.assert_array_equal(got.matched_cls[n].numpy()[fg],
                                      np.asarray(want.matched_cls)[fg])
        np.testing.assert_allclose(got.pred_iou[n].numpy(),
                                   np.asarray(want.pred_iou), atol=1e-6)
        assert float(got.num_fg[n]) == float(want.num_fg)
        assert float(got.num_gt[n]) == float(want.num_gt)
    # the cases are what they claim: the corner gt has fewer than 10
    # candidates, image 1 no foreground, image 2 ties resolved to gt 0
    in_box, in_center, _ = get_geometry_constraints(
        *(torch.from_numpy(a) for a in (gt, valid, xc, yc, ss)), 2.5)
    assert 0 < int((in_box | in_center)[0, 2].sum()) < 10
    assert got.fg_mask[1].sum() == 0 and got.fg_mask[2].sum() > 1
    assert (got.matched_gt[2][got.fg_mask[2]] == 0).all()


def _level_outs(rng, N=3):
    return [rng.normal(0, 1, (N, h, w, 5 + NC)).astype(np.float32)
            for h, w in HW]


def _labels(rng, N=3, G=10):
    labels = np.zeros((N, G, 5), np.float32)
    for b in range(N - 1):                  # the last image has no gt
        g = int(rng.integers(2, 6))
        labels[b, :g] = np.stack([rng.integers(0, NC, g),
                                  rng.uniform(10, W - 10, g),
                                  rng.uniform(10, H - 10, g),
                                  rng.uniform(6, 40, g),
                                  rng.uniform(6, 30, g)], -1)
    return labels


def test_losses_and_their_gradients_match_jax(rng):
    outs, labels = _level_outs(rng), _labels(rng)

    def jax_total(o):
        losses = jax_detector_loss(o, jnp.asarray(labels), STRIDES, NC, 2.5)
        return losses["total_loss"], losses
    (_, want), want_g = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        [jnp.asarray(o) for o in outs])

    t_outs = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = detector_loss(t_outs, torch.from_numpy(labels), STRIDES, NC, 2.5)
    got["total_loss"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-4,
                                   err_msg=k)
    for lvl, (t, g) in enumerate(zip(t_outs, want_g)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6,
                                   err_msg=f"d total_loss / d level {lvl}")


def test_batchnorm_training_statistics_match_flax(rng):
    """Biased variance in the running statistics (n = 2 * 2 * 3 = 12),
    flax's momentum 0.9; the same output; stock nn.BatchNorm2d's unbiased
    update would be off by far more than the gate."""
    x = rng.normal(1.5, 2.0, (2, 2, 3, 5)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.5, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.5, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    bn = SpmdBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    port = BatchNorm2d(5, eps=1e-5)
    stock = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1)
    for mod in (port, stock):
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(scale))
            mod.bias.copy_(torch.from_numpy(bias))
            mod.running_mean.copy_(torch.from_numpy(mean0))
            mod.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = port.train()(xt)
    stock.train()(xt)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-5)
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), want_var, atol=1e-6)
    assert np.abs(stock.running_var.numpy() - want_var).max() > 1e-2


def test_adam_with_yolox_schedule_matches_optax(rng):
    """Adam on the yolox warm-up/cosine schedule, both fed the same three
    gradient trees: the lr of update i is the schedule at i."""
    sched = dict(lr=1e-3, min_lr_ratio=0.05, total_iters=10,
                 warmup_total_iters=2)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1e-2 * (i + 1), s).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]

    tx = optax.adam(jax_schedule.yolox_warm_cos_schedule(**sched))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(j_params)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()},
                                       opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)

    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    state = create_train_state(
        module, adam(schedule.yolox_warm_cos_schedule(**sched)),
        device="cpu")
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    assert state.step == 3
    for k, p in module.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(j_params[k]), atol=1e-6,
                                   err_msg=k)


def test_optimizer_steps_bump_version_counters():
    """The kernel stems' weight cache reads each parameter's version
    counter (models/stem_chain.packed_weights): the port's optimiser steps
    update the parameters in place and bump it."""
    for tx in (adam(1e-3), sgd(1e-2)):
        p = torch.nn.Parameter(torch.ones(3))
        opt = tx.make([("p", p)])
        p.grad = torch.ones(3)
        before = p._version
        opt.step()
        assert p._version > before and not torch.equal(p.detach(),
                                                        torch.ones(3))


SCHEDULES = {
    "yolox_warm_cos_schedule": dict(lr=0.01, min_lr_ratio=0.05,
                                    total_iters=50, warmup_total_iters=5,
                                    warmup_lr_start=1e-4, no_aug_iter=8),
    "cos_schedule": dict(lr=0.01, total_iters=50),
    "warm_cos_schedule": dict(lr=0.01, total_iters=50, warmup_total_iters=5),
    "multistep_schedule": dict(lr=0.01, milestones=(10, 30), gamma=0.1),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    got = getattr(schedule, name)(**SCHEDULES[name])
    want = getattr(jax_schedule, name)(**SCHEDULES[name])
    for step in range(60):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-9,
                                   err_msg=f"{name} step {step}")


@pytest.mark.parametrize("updates", [1, 100, 5000])
def test_ema_update_matches_jax(rng, updates):
    ema = {k: rng.normal(0, 1, (5, 3)).astype(np.float32) for k in "ab"}
    params = {k: rng.normal(0, 1, (5, 3)).astype(np.float32) for k in "ab"}
    want = jax_ema.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                              {k: jnp.asarray(v) for k, v in params.items()},
                              updates)
    got = ema_update({k: torch.from_numpy(v.copy()) for k, v in ema.items()},
                     {k: torch.from_numpy(v) for k, v in params.items()},
                     updates)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_dropout_trains_only_and_follows_its_generator():
    drop = Dropout(0.1)
    x = torch.ones(1000, 1000)
    assert drop.eval()(x) is x
    drop.train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    drop.generator = torch.Generator().manual_seed(5)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    drop.generator = torch.Generator().manual_seed(5)
    assert torch.equal(drop(x), y)
    drop.generator = torch.Generator().manual_seed(6)
    assert not torch.equal(drop(x), y)


def test_bfm_stem_dropout_is_active_in_training_only():
    model = build_detector(NC, stem="bfm", train=True, **NARROW)
    stem = model.backbone.stem
    assert stem.drop_up.rate == stem.drop_down.rate == 0.1
    x = torch.rand(2, H, W, 16)
    outs = []
    for seed in (0, 0, 1):
        stem.drop_up.generator = stem.drop_down.generator = \
            torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(stem(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    stem.eval()
    with torch.no_grad():
        assert torch.equal(stem(x), stem(x))


@pytest.mark.parametrize("stem,shape", [("bfm_folded", (2, 8, 12 * 64)),
                                        ("bfm_p64_kernel", (2, 8, 12, 64))])
def test_kernel_stems_refuse_training(stem, shape):
    """bfm_folded (B4) and bfm_p64_kernel (B7) raise in training mode and
    where a gradient is asked for; they serve under no_grad."""
    model = build_detector(NC, stem=stem, **NARROW)
    mod = model.backbone.stem
    assert isinstance(mod, (BinsFusionModuleFolded,
                            BinsFusionModulePatchedKernel))
    x = torch.rand(shape)
    with pytest.raises(RuntimeError, match="has no backward"):
        mod(x)
    with torch.no_grad():
        assert torch.isfinite(mod(x)).all()
    mod.train()
    with torch.no_grad(), pytest.raises(RuntimeError, match="does not train"):
        mod(x)
    state = create_train_state(model, adam(1e-3), device="cpu")
    step = make_train_step(STRIDES, NC, 2.5, device="cpu")
    with pytest.raises(RuntimeError, match="does not train"):
        step(state, x, torch.zeros(2, 4, 5), torch.Generator())


def test_entry_points_need_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_detector(NC, stem="bfm", train=True, **NARROW)
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(model, adam(1e-3))
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(STRIDES, NC, 2.5)
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_step(STRIDES)
    with pytest.raises(RuntimeError, match="cuda"):
        run_train("gen1_train", model=model)
    # the profile reads the card's kernels: refused before any work
    with pytest.raises(ValueError, match="card"):
        run_train("gen1_train", model=model, device="cpu", profile=True)


@pytest.mark.parametrize("exp_type", sorted(jax_config.EXP_TYPES))
def test_config_matches_jax(exp_type):
    got = config.make_config(exp_type, dataset="gen4", batch_size=32)
    want = jax_config.make_config(exp_type, dataset="gen4", batch_size=32)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("img_size", "sensor_hw", "num_classes", "center_radius",
                 "init_lr", "input_channels", "uses_taf_dataset"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_run_train_on_the_cpu(kind):
    """The bench's synthetic batches (40 label rows, 3 to 19 valid) through
    run_train at a small size: finite losses, masters f32 and moved."""
    rng = np.random.default_rng(0)
    (vol, labels), = synthetic_batches(rng, 1, 3, (H, W), NC, kind)
    n_valid = (labels.sum(-1) > 0).sum(-1)
    assert vol.shape == (3, H, W, 16) and labels.shape == (3, 40, 5)
    assert ((3 <= n_valid) & (n_valid <= 19)).all()
    model = build_detector(NC, stem="bfm", train=True, **NARROW)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rep = run_train(dict(input_hw=(H, W), batch=2, num_classes=NC),
                    steps=1, warmup=1, events_kind=kind, model=model,
                    device="cpu")
    assert rep["state"].step == 2 and len(rep["losses"]) == 2
    assert all(np.isfinite(v) for lo in rep["losses"] for v in lo.values())
    assert rep["flops_per_step"] > 0 and rep["peak_bytes"] is None
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            continue
        assert v.dtype == torch.float32
        # a master whose last gradient is zero (a tower with no positive
        # anchor at this size) may stay put
        if k not in grads or grads[k].abs().sum() > 0:
            assert not torch.equal(v, before[k]), k
