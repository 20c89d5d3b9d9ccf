"""The red family of the port (models/red.py: SEResNet, MemoryLayers,
SSDBoxPredictor, REDDetector, the priors, coding, matching and MultiBox
loss; the red Trainer) against the JAX package's on the CPU.

Weights go across with weights.load_flax_variables: JAX's variables tree
(by eval_shape of its init) filled from a seed
(test_torch_port_memory.seeded_variables). Gates: the f32 forward and
the carries over three windows within 2e-4 (the torch-import parity gate)
at an odd input size; build_priors equal; assign_priors and
hard_negative_mining equal, with targets sharing a best prior and with
tied losses; red_loss's losses within rtol 1e-6 and its gradients within
1e-6 in f64; red_eval_decode within 1e-5; the steps the red Trainer
builds against JAX's step functions in f64 (detections within 1e-4,
losses within rtol 2e-4, BatchNorm statistics within 1e-5); a port
REDDetector through JAX's importer (weights.flax_path) and back, equal.

RED's 13 conv-BN sites (the stem's, and c1, c2, c3 and the SE-gated
`down` of each SEBottleneck) end in blocks.conv_epilogue. With the fused
path's dispatch on the CPU (`epilogue.KERNEL_DEVICE` "cpu", the twin in
the kernel's place), a bf16 channels_last eval forward fuses every site,
each within one bf16 ulp of its unfused f32 steps on its own operands
(tests/test_torch_port_bn_act.py's tolerance), and lies within relative
L2 1e-2 of the separate passes; the separate passes are the arithmetic
of the blocks before the epilogue, bit for bit; training counts neither.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict

from frlw_evd_tpu.models import red as jred
from frlw_evd_tpu.train.checkpoints import import_torch_checkpoint
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models import epilogue, red
from frlw_evd_tpu.train.trainer import \
    make_red_eval_step as j_make_red_eval_step
from frlw_evd_tpu.train.trainer import \
    make_red_train_step as j_make_red_train_step
from frlw_evd_tpu_torch.train import (TrainState, Trainer, make_config,
                                      make_red_train_step, sgd)
from frlw_evd_tpu_torch.weights import (flax_path, flax_to_state_dict,
                                        load_flax_variables)
from test_torch_port_bn_act import _counted, _unfused, assert_within_ulps
from test_torch_port_memory import _two_torch_threads  # noqa: F401
from test_torch_port_memory import (random_labels, seeded_variables,
                                    steps_against_jax)

TOL = 2e-4
ODD = (67, 93)                       # backbone 5x6, pyramid 3x3 ... 1x1
C_IN = 10
SITES = 13      # RED's conv epilogues a forward: the stem's, 4 a block


@pytest.fixture(scope="module")
def red_pair():
    """(flax REDDetector, its randomised variables, the port's on them)."""
    jm = jred.REDDetector(2)
    variables = seeded_variables(jm, np.random.default_rng(0),
                                 jm.init_carries(1, *ODD),
                                 jnp.zeros((1, *ODD, C_IN)), False)
    tm = load_flax_variables(red.REDDetector(2, C_IN), variables).eval()
    return jm, variables, tm


def _close(got, want, what, tol=TOL):
    if isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", tol)
        return
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0, err_msg=what)


def test_red_detector_and_carries_over_three_windows(red_pair):
    """Three windows at 67x93, the carries threaded from init_carries: the
    class logits and box regressions of each window and the five (h, c)
    carries after it. Torch's Conv2d(k, s=2, p=(k-1)//2) gives flax's
    ceil-halved sizes."""
    jm, variables, tm = red_pair
    windows = np.random.default_rng(1).uniform(0, 1, (3, 2, *ODD, C_IN)
                                               ).astype(np.float32)
    apply = jax.jit(lambda c, x: jm.apply(variables, c, x, False))
    j_c = jm.init_carries(2, *ODD)
    t_c = red.REDDetector.init_carries(2, *ODD)
    assert [tuple(h.shape[1:3]) for h, _ in t_c] == red.pyramid_shapes(*ODD)
    _close(t_c, j_c, "init_carries")
    for t, x in enumerate(windows):
        j_c, j_out = apply(j_c, jnp.asarray(x))
        with torch.no_grad():
            t_c, t_out = tm(t_c, torch.from_numpy(x))
        assert t_out[0].shape == (2, len(red.build_priors(*ODD)), 3)
        _close(t_out, j_out, f"window {t} outputs")
        _close(t_c, j_c, f"window {t} carries")


@pytest.mark.parametrize("hw", [(256, 320), (128, 160), ODD, (512, 640)])
def test_build_priors_equal(hw):
    got = red.build_priors(*hw)
    want = jred.build_priors(*hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert red.pyramid_shapes(*hw) == jred.pyramid_shapes(*hw)


def _targets(rng, n_valid, G=6, shared=False):
    """(G, 4) corner boxes in [0, 1], labels 1..2, the first n_valid
    valid; with `shared`, targets 1 and 2 are copies of target 0 shifted
    by 1e-4, so all three force the same best prior."""
    xy = rng.uniform(0.0, 0.7, (G, 2))
    wh = rng.uniform(0.05, 0.3, (G, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if shared:
        boxes[1:3] = boxes[0] + np.float32(1e-4)
    labels = rng.integers(1, 3, G).astype(np.int32)
    valid = np.arange(G) < n_valid
    return boxes, labels, valid


@pytest.mark.parametrize("case", ["random", "shared_best_prior",
                                  "all_padding"])
def test_assign_priors_equal(case):
    """The port's batched assign_priors against JAX's per sample: labels
    and boxes equal. Where targets share a best prior the later one wins
    in both (JAX's .at[].set on the CPU writes in order; the port takes
    the largest index by a scatter-max)."""
    priors = red.build_priors(128, 160)
    p_corner = jred.center_to_corner(jnp.asarray(priors))
    rng = np.random.default_rng(4)
    samples = [_targets(rng, {"random": 4, "shared_best_prior": 5,
                              "all_padding": 0}[case],
                        shared=case == "shared_best_prior")
               for _ in range(3)]
    got_boxes, got_labels = red.assign_priors(
        *(torch.from_numpy(np.stack(a)) for a in zip(*samples)),
        red.center_to_corner(torch.from_numpy(priors)))
    for i, (b, l, v) in enumerate(samples):
        want_boxes, want_labels = jred.assign_priors(
            jnp.asarray(b), jnp.asarray(l), jnp.asarray(v), p_corner)
        np.testing.assert_array_equal(got_labels[i].numpy(),
                                      np.asarray(want_labels))
        np.testing.assert_array_equal(got_boxes[i].numpy(),
                                      np.asarray(want_boxes))
        if case == "shared_best_prior":
            best = np.asarray(jred.iou_corner(
                jnp.asarray(b)[None], p_corner[:, None])).argmax(0)
            assert best[0] == best[1] == best[2]
            np.testing.assert_array_equal(got_boxes[i, best[0]].numpy(),
                                          b[2])
        if case == "all_padding":
            assert not got_labels[i].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hard_negative_mining_equal_with_ties(seed):
    """Background losses from four values, so most are tied: the stable
    double argsort ranks ties by index, as jnp.argsort does."""
    rng = np.random.default_rng(seed)
    loss = rng.integers(0, 4, (3, 200)).astype(np.float32)
    labels = np.where(rng.random((3, 200)) < 0.05,
                      rng.integers(1, 3, (3, 200)), 0).astype(np.int32)
    labels[2] = 0
    got = red.hard_negative_mining(torch.from_numpy(loss),
                                   torch.from_numpy(labels), 3)
    want = jred.hard_negative_mining(jnp.asarray(loss), jnp.asarray(labels),
                                     3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].sum() == 4 * (labels[0] > 0).sum()


def _loss_inputs(rng, hw=(128, 160), N=3, G=8):
    priors = red.build_priors(*hw)
    P = len(priors)
    cls_logits = rng.normal(0, 1, (N, P, 3))
    bbox_pred = rng.normal(0, 0.5, (N, P, 4))
    labels = np.zeros((N, G, 5))
    for n in range(N):
        k = 2 + n
        cxcy = rng.uniform(20, 120, (k, 2))
        wh = rng.uniform(8, 60, (k, 2))
        labels[n, :k] = np.concatenate(
            [rng.integers(0, 2, (k, 1)), cxcy, wh], 1)
    return priors, cls_logits, bbox_pred, labels


def test_red_loss_and_gradients_match_jax_in_f64():
    """red_loss in f64 on both sides: each loss within rtol 1e-6, the
    gradients with respect to the logits and the regressions within
    1e-6."""
    priors, cls_logits, bbox_pred, labels = _loss_inputs(
        np.random.default_rng(5))
    h, w = 128, 160
    with jax.enable_x64(True):
        def j_total(c, b):
            out = jred.red_loss(c, b, jnp.asarray(labels), h, w, priors)
            return out["total_loss"], out

        (_, j_out), j_grads = jax.jit(jax.value_and_grad(
            j_total, argnums=(0, 1), has_aux=True))(jnp.asarray(cls_logits),
                                                    jnp.asarray(bbox_pred))
        j_out = {k: float(v) for k, v in j_out.items()}
        j_grads = [np.asarray(g) for g in j_grads]
    c = torch.tensor(cls_logits, requires_grad=True)
    b = torch.tensor(bbox_pred, requires_grad=True)
    out = red.red_loss(c, b, torch.from_numpy(labels), h, w, priors)
    out["total_loss"].backward()
    assert out.keys() == j_out.keys()
    for k, v in j_out.items():
        np.testing.assert_allclose(out[k].item(), v, rtol=1e-6, err_msg=k)
    for name, g, jg in (("cls_logits", c.grad, j_grads[0]),
                        ("bbox_pred", b.grad, j_grads[1])):
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-6, rtol=0,
                                   err_msg=name)


def test_red_eval_decode_matches_jax():
    priors, cls_logits, bbox_pred, _ = _loss_inputs(np.random.default_rng(6))
    cls_logits, bbox_pred = (a.astype(np.float32)
                             for a in (cls_logits, bbox_pred))
    got = red.red_eval_decode(torch.from_numpy(cls_logits),
                              torch.from_numpy(bbox_pred), priors, 128, 160)
    want = jred.red_eval_decode(jnp.asarray(cls_logits),
                                jnp.asarray(bbox_pred), priors, 128, 160)
    assert got.shape == want.shape == (3, len(priors), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_red_bf16_step_computes_the_memory_in_f32():
    """half_precision: the backbone in bf16, the ConvLSTMs from the f32
    carries on in f32 (flax's promotion, JAX trainer.py:143); one step's
    losses finite."""
    model = red.REDDetector(2, C_IN).train()
    seen = []
    model.memory.lstms_0.register_forward_hook(
        lambda m, args, out: seen.append((args[1].dtype, out[1].dtype)))
    model.predictor.register_forward_hook(
        lambda m, args, out: seen.append(out[0].dtype))
    state = TrainState(0, model, sgd(1e-3).make(model.named_parameters()))
    priors = red.build_priors(64, 96)
    labels = np.zeros((2, 4, 5), np.float32)
    labels[:, 0] = [1, 40, 30, 20, 16]
    losses = make_red_train_step(64, 96, priors, half_precision=True,
                                 device="cpu")(
        state, torch.rand(2, 64, 96, C_IN), torch.from_numpy(labels),
        torch.Generator())
    assert seen == [(torch.bfloat16, torch.float32), torch.float32]
    assert all(torch.isfinite(v) for v in losses.values())
    assert next(model.parameters()).dtype == torch.float32


def test_trainer_red_steps_match_jax(red_pair, tmp_path):
    """red: the Trainer builds a REDDetector; its steps (fresh f32 carries
    every batch; the MultiBox loss over build_priors of the config's size;
    red_eval_decode, conf 0.01, NMS 0.45, 15 detections) against JAX's
    make_red_train_step and make_red_eval_step, batch 2 at 67x93, the
    full-width model (red has no width knob), f64 (steps_against_jax)."""
    jm, variables, _ = red_pair
    pt = Trainer(make_config("red", batch_size=2, half_precision=False,
                             img_size_override=ODD, log_path=str(tmp_path)),
                 device="cpu")
    assert type(pt.model).__name__ == "REDDetector"
    pt.model = load_flax_variables(red.REDDetector(2, C_IN),
                                   variables).double()
    pt.build(1)
    priors = jred.build_priors(*ODD)
    rng = np.random.default_rng(8)
    steps_against_jax(
        pt, jm, variables, j_make_red_train_step(2, *ODD, priors),
        j_make_red_eval_step(2, *ODD, priors),
        rng.uniform(0, 1, (2, *ODD, C_IN)), random_labels(rng, 2, ODD))


def test_red_weights_round_trip_through_jax_importer(red_pair, tmp_path):
    """A port REDDetector's state_dict through JAX's importer with
    rename_fn=flax_path (its BatchNorms `bn1`, `c1_bn`, `down_bn` map to
    scale / bias, not kernel) and back with flax_to_state_dict: every key
    loaded, every tensor equal."""
    jm, variables, tm = red_pair
    gen = torch.Generator().manual_seed(7)
    sd = {k: (v + torch.randn(v.shape, generator=gen).abs()
              if v.is_floating_point() else v.clone())
          for k, v in tm.state_dict().items()}
    path = tmp_path / "red.pth"
    torch.save(sd, path)
    params, stats, report = import_torch_checkpoint(
        str(path), variables["params"], variables["batch_stats"],
        rename_fn=flax_path, strict=True)
    n_keys = sum(1 for k in sd if not k.endswith("num_batches_tracked"))
    assert report["loaded"] == n_keys and report["unmatched"] == []
    assert flatten_dict(params).keys() == flatten_dict(
        variables["params"]).keys()
    back = load_flax_variables(red.REDDetector(2, C_IN),
                               {"params": params, "batch_stats": stats})
    for k, v in back.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    assert flax_path("backbone.layer1.c1_bn.weight") == (
        "params", ("backbone", "layer1", "c1_bn", "scale"))
    assert flax_path("backbone.bn1.weight")[1][-1] == "scale"
    assert flax_path("backbone.conv1.weight")[1][-1] == "kernel"
    assert flax_to_state_dict({"params": params}).keys() <= sd.keys()


# RED's conv-BN sites through blocks.conv_epilogue (models/epilogue.py)

@pytest.fixture
def on_cpu(monkeypatch):
    """The fused path's dispatch on CPU tensors (the twin in the kernel's
    place)."""
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "cpu")


def _spread_bn(module, seed):
    """BatchNorm statistics and affines away from the identity, so that a
    site that misreads them shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.normal_(1.0, 0.3, generator=g)
                m.bias.normal_(0.0, 0.3, generator=g)
    return module


def _eval_in(module, dtype):
    """`module` at eval in `dtype`, channels_last (as the card serves it)."""
    return pipeline.channels_last_(module.to(dtype).eval())


def _old_block(block, x):
    """SEBottleneck's forward as the separate passes it ran before the
    epilogue (red.py:42-73 step by step)."""
    def conv_bn(name, h):
        return getattr(block, f"{name}_bn")(
            getattr(block, f"{name}_conv")(h))

    out = F.relu(conv_bn("c1", x))
    out = F.relu(conv_bn("c2", out))
    out = conv_bn("c3", out)
    se = out.mean(dim=(2, 3), keepdim=True)
    se = torch.sigmoid(block.conv_up(F.relu(block.conv_down(se))))
    return se * out + conv_bn("down", x)


def _recorded_sites(monkeypatch):
    """Each fused site's operands and output, in call order
    (epilogue.apply wrapped)."""
    calls, apply = [], epilogue.apply

    def record(*args):
        out = apply(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(epilogue, "apply", record)
    return calls


def _assert_sites_within_one_ulp(calls):
    for (x, mean, var, weight, bias, eps, act, residual, gate), out in calls:
        want = _unfused(x, mean, var, weight, bias, eps, act, residual,
                        gate=gate).to(torch.bfloat16)
        assert_within_ulps(out, want, x, mean, var, weight, bias, eps,
                           residual, gate=gate)


def _rel(got, want):
    a = torch.cat([t.double().flatten() for t in got])
    b = torch.cat([t.double().flatten() for t in want])
    return ((a - b).norm() / b.norm()).item()


def _bf16_input(shape, seed):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def test_se_bottleneck_bf16_eval_fuses_its_four_sites(on_cpu, monkeypatch):
    """c1 and c2 with relu, c3 linear, and `down` linear with c3's output
    as its residual gated by the SE map (N, C, 1, 1): four fused sites, at
    an odd batch."""
    torch.manual_seed(0)
    block = _eval_in(_spread_bn(red.SEBottleneck(32, 64, 2), 1),
                     torch.bfloat16)
    x = _bf16_input((3, 32, 12, 10), 2)
    calls = _recorded_sites(monkeypatch)
    with torch.no_grad():
        got, counts = _counted(lambda: block(x))
        old = _old_block(block, x)
    assert counts == {"epilogue_fused": 4}
    assert [args[6] for args, _ in calls] == ["relu", "relu", "linear",
                                              "linear"]
    (*_, residual, gate), _ = calls[3]
    assert residual is calls[2][1] and gate.shape == (3, 64, 1, 1)
    assert all(args[8] is None for args, _ in calls[:3])
    _assert_sites_within_one_ulp(calls)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # one rounding a site where the old path had two to four: close
    rel = _rel([got], [old])
    assert 0 < rel < 1e-2, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_se_bottleneck_separate_passes_are_the_old_arithmetic(dtype):
    """Off the kernel's device every site takes the separate passes
    (counted plain), and the block computes what it computed before the
    epilogue, bit for bit: bn(down) + se * c3 is se * c3 + bn(down)."""
    torch.manual_seed(0)
    block = _eval_in(_spread_bn(red.SEBottleneck(32, 64, 2), 3), dtype)
    x = _bf16_input((3, 32, 12, 10), 4).to(dtype)
    with torch.no_grad():
        got, counts = _counted(lambda: block(x))
        assert torch.equal(got, _old_block(block, x))
    assert counts == {"epilogue_plain": 4}


def test_red_detector_bf16_eval_fuses_its_13_sites(on_cpu, monkeypatch):
    """A bf16 channels_last REDDetector at eval over two windows (fresh,
    then carried f32 memory): 13 fused sites a forward and none plain, each
    within one bf16 ulp of its unfused f32 steps; the separate passes
    count 13 plain, and the fused outputs and carries lie within relative
    L2 1e-2 of theirs."""
    torch.manual_seed(0)
    model = _eval_in(_spread_bn(red.REDDetector(2, C_IN), 5),
                     torch.bfloat16)
    g = torch.Generator().manual_seed(6)
    windows = torch.rand((2, 2, 64, 96, C_IN), generator=g)
    calls = _recorded_sites(monkeypatch)
    outs = {}
    for seam, kind in (("cpu", "epilogue_fused"), ("cuda", "epilogue_plain")):
        monkeypatch.setattr(epilogue, "KERNEL_DEVICE", seam)
        carries = red.REDDetector.init_carries(2, 64, 96)
        flat = []
        for x in windows:
            with torch.no_grad():
                (carries, maps), counts = _counted(lambda: model(carries, x))
            assert counts == {kind: SITES}
            flat += [*maps, *(t for pair in carries for t in pair)]
        outs[seam] = flat
    assert len(calls) == 2 * SITES
    assert sum(args[8] is not None for args, _ in calls) == 2 * 3
    _assert_sites_within_one_ulp(calls)
    rel = _rel(outs["cpu"], outs["cuda"])
    assert 0 < rel < 1e-2, rel


def test_red_training_forward_counts_neither(on_cpu):
    """A training forward (batch statistics) takes the separate passes and
    counts no epilogue; its gradient reaches the first conv."""
    torch.manual_seed(0)
    model = _eval_in(_spread_bn(red.REDDetector(2, C_IN), 7),
                     torch.bfloat16).train()
    x = torch.rand((2, 64, 96, C_IN),
                   generator=torch.Generator().manual_seed(8))
    (_, (cls, box)), counts = _counted(lambda: model(
        red.REDDetector.init_carries(2, 64, 96), x))
    assert counts == {}
    (cls.float().sum() + box.float().sum()).backward()
    assert model.backbone.conv1.weight.grad is not None
