"""The yolov3 family of the port (models/yolov3.py: Darknet-53, the FPN
with the align-corners bilinear upsample, the anchor head, decode, GIoU,
the loss, gt_creator; models/pafpn.py: _ConvSet, YOLOFPN; the CLIs of
this slice's families) against the JAX package's on the CPU.

Weights go across with weights.load_flax_variables: JAX's variables tree
(by eval_shape of its init; the full-width detector: the family has no
width knob) filled from a seed (test_torch_port_memory.seeded_variables).
Gates: the f32 forward at 64x64 within 2e-4 (the torch-import parity
gate); with BatchNorm scales U(1, 1.25), one SGD step in f64 with its
losses within rtol 2e-4 and its BatchNorm statistics within 1e-5 of JAX's
make_yolov3_train_step; yolov3_loss's losses within rtol 1e-6 and its
gradients within 1e-6 in f64; decode, GIoU and the eval decode within
1e-5; gt_creator equal; the upsample
within 1e-6. cli.train and cli.test run yolov3, yolov3_taf_bfm, red,
convlstm and recconv at a square 64x64: losses finite, best_epoch
written and scored.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import yolov3 as jy
from frlw_evd_tpu.models.pafpn import YOLOFPN as JYOLOFPN
from frlw_evd_tpu.train.trainer import TrainState as JTrainState
from frlw_evd_tpu.train.trainer import \
    make_yolov3_train_step as j_make_yolov3_train_step
from frlw_evd_tpu_torch.cli import test as cli_test
from frlw_evd_tpu_torch.cli import train as cli_train
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.models import yolov3 as ty
from frlw_evd_tpu_torch.models.pafpn import YOLOFPN
from frlw_evd_tpu_torch.train import TrainState, make_yolov3_train_step, sgd
from frlw_evd_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from test_torch_port_memory import _two_torch_threads  # noqa: F401
from test_torch_port_memory import seeded_variables

S, C_IN, NC = 64, 10, 2
TOL = 2e-4
STATS = ("running_mean", "running_var")
V3_LOSSES = {"total_loss", "obj_loss", "cls_loss", "iou_loss"}
RED_LOSSES = {"total_loss", "iou_loss", "cls_loss"}
AED_LOSSES = {"total_loss", "iou_loss", "obj_loss", "cls_loss",
              "num_fg_per_gt"}
# [class, cx, cy, w, h] in pixels of the 64x64 input; the last row pads
LABELS = np.array([[[0, 20, 20, 12, 16], [1, 40, 44, 30, 24],
                    [0, 33, 30, 50, 40], [0, 0, 0, 0, 0]],
                   [[1, 10, 50, 8, 9], [0, 50, 14, 20, 12],
                    [1, 31, 31, 0.5, 20], [0, 0, 0, 0, 0]]], np.float32)


def _spread_scales(variables, rng):
    """BatchNorm scales U(1, 1.25), so the step's statistics matter."""
    flat = flatten_dict(variables["params"])
    for path in flat:
        if path[-2] == "bn" and path[-1] == "scale":
            flat[path] = rng.uniform(1.0, 1.25, flat[path].shape).astype(
                np.float32)
    return {**variables, "params": unflatten_dict(flat)}


@pytest.fixture(scope="module")
def v3_pair():
    """(flax YOLOv3Detector, its randomised variables, the port's on them),
    the plain conv stem over 10 channels."""
    jm = jy.YOLOv3Detector(NC)
    variables = seeded_variables(jm, np.random.default_rng(0),
                                 jnp.zeros((1, S, S, C_IN)), False)
    tm = load_flax_variables(ty.YOLOv3Detector(NC, C_IN), variables)
    return jm, variables, tm


def test_yolov3_detector_matches_flax(v3_pair):
    """Darknet-53 → FPN → head, eval mode, batch 1: the three NHWC maps
    (N, 64 / s, 64 / s, 3 * (1 + 2 + 4))."""
    jm, variables, tm = v3_pair
    x = np.random.default_rng(1).uniform(0, 1, (1, S, S, C_IN)).astype(
        np.float32)
    want = jax.jit(lambda v, xx: jm.apply(v, xx, False))(variables,
                                                        jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    for lvl, (g, j) in enumerate(zip(got, want)):
        assert g.shape == j.shape == (1, S // 8 // 2 ** lvl,
                                      S // 8 // 2 ** lvl, 21)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL,
                                   rtol=0, err_msg=f"level {lvl}")


def test_yolov3_bfm_variant_carries_jax_tree():
    """yolov3_taf_bfm: the BFM stem `layer_1` in place of the l1 group;
    every flax variable has its port key and shape (JAX's tree by
    eval_shape, no compile), and the head's det biases start at the focal
    prior on the first 3 channels only, as JAX's bias_init."""
    jm = jy.YOLOv3Detector(NC, use_bfm_stem=True)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, S, S, 16)), False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = load_flax_variables(ty.YOLOv3Detector(NC, 16, use_bfm_stem=True),
                             variables)
    assert type(tm.backbone.layer_1).__name__ == "BinsFusionModule"
    assert not hasattr(tm.backbone, "l1_conv1")
    from frlw_evd_tpu_torch.models.detector import init_parameters_
    init_parameters_(tm, torch.Generator().manual_seed(0))
    prior = -np.log((1 - 1e-2) / 1e-2)
    for k in (1, 2, 3):
        bias = getattr(tm.head, f"head_det_{k}").bias.detach().numpy()
        np.testing.assert_allclose(bias[:3], prior, rtol=1e-6)
        assert not bias[3:].any()


def _gt(labels=LABELS, **kw):
    return ty.gt_creator(S, ty.STRIDES, labels, **kw)


def test_yolov3_train_step_matches_jax(v3_pair):
    """One SGD(1e-2) step, batch 2 at 64x64, BatchNorm scales U(1, 1.25),
    the network in f64 on both sides (the head maps cast to f32 for the
    loss, as both steps do): the four losses within rtol 2e-4 and the
    BatchNorm running statistics within 1e-5 of JAX's
    make_yolov3_train_step (trainer.py:76-105). In f32 the order of the
    convolutions' sums alone moves the running variance of l5_conv (1024
    channels on 2x2 maps, 52 convolutions deep) by 2.4e-5, 1.5e-5 of
    itself; f64 takes that noise out, so the gates test the algorithm."""
    jm, variables, _ = v3_pair
    variables = _spread_scales(variables, np.random.default_rng(2))
    imgs = np.random.default_rng(3).uniform(0, 1, (2, S, S, C_IN))
    gt = _gt()
    assert gt[..., 0].sum() >= 5
    tx = optax.sgd(1e-2)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=v64["params"],
                            batch_stats=v64["batch_stats"],
                            opt_state=tx.init(v64["params"]), tx=tx,
                            apply_fn=jm.apply)
        j_state, j_losses = j_make_yolov3_train_step(NC, S)(
            state, jnp.asarray(imgs), jnp.asarray(gt), jax.random.key(1))
        j_losses = {k: float(v) for k, v in j_losses.items()}
        j_stats = {k: v.double() for k, v in flax_to_state_dict(
            {"batch_stats": jax.tree.map(np.asarray, j_state.batch_stats)}
        ).items()}

    tm = load_flax_variables(ty.YOLOv3Detector(NC, C_IN),
                             variables).double().train()
    t_state = TrainState(0, tm, sgd(1e-2).make(tm.named_parameters()))
    losses = make_yolov3_train_step(NC, S, device="cpu")(
        t_state, torch.from_numpy(imgs), torch.from_numpy(gt),
        torch.Generator())
    assert set(losses) == set(j_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), j_losses[k], rtol=2e-4,
                                   err_msg=k)
    sd = tm.state_dict()
    stats = [k for k in sd if k.endswith(STATS)]
    assert stats and set(stats) == set(j_stats)
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), j_stats[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def _maps(rng, n=2, dtype=np.float32):
    return [rng.normal(0, 1, (n, S // s, S // s, 21)).astype(dtype)
            for s in ty.STRIDES]


def test_decode_boxes_and_eval_decode_match_jax():
    maps = _maps(np.random.default_rng(4))
    t_maps = [torch.from_numpy(m) for m in maps]
    j_maps = [jnp.asarray(m) for m in maps]
    j_decoded, want = jax.jit(lambda ms: (
        jy.decode_boxes(ms, NC, S), jy.yolov3_eval_decode(ms, NC, S)))(
            j_maps)
    for got, j in zip(ty.decode_boxes(t_maps, NC, S), j_decoded):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    got = ty.yolov3_eval_decode(t_maps, NC, S)
    assert got.shape == want.shape == (2, 3 * (64 + 16 + 4), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_giou_matches_jax():
    """Overlapping, disjoint, nested and zero-area pairs."""
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 1, (500, 2, 2))
    wh = rng.uniform(0, 0.5, (500, 2, 2))
    wh[:20] = 0.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    a, b = boxes[:, 0], boxes[:, 1]
    b[20:40] = a[20:40]
    got = ty.giou_xyxy(torch.from_numpy(a), torch.from_numpy(b))
    want = jy.giou_xyxy(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_yolov3_loss_and_gradients_match_jax_in_f64():
    """yolov3_loss in f64 on both sides: each loss within rtol 1e-6, the
    gradient of total_loss with respect to each head map within 1e-6."""
    maps = _maps(np.random.default_rng(6), dtype=np.float64)
    gt = _gt(multi_anchor=True)
    with jax.enable_x64(True):
        def total(ms):
            out = jy.yolov3_loss(ms, jnp.asarray(gt), NC, S)
            return out["total_loss"], out

        (_, j_out), j_grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))([jnp.asarray(m) for m in maps])
        j_out = {k: float(v) for k, v in j_out.items()}
        j_grads = [np.asarray(g) for g in j_grads]
    t_maps = [torch.tensor(m, requires_grad=True) for m in maps]
    out = ty.yolov3_loss(t_maps, torch.from_numpy(gt), NC, S)
    out["total_loss"].backward()
    assert out.keys() == j_out.keys()
    for k, v in j_out.items():
        np.testing.assert_allclose(out[k].item(), v, rtol=1e-6, err_msg=k)
    for lvl, (m, jg) in enumerate(zip(t_maps, j_grads)):
        np.testing.assert_allclose(m.grad.numpy(), jg, atol=1e-6, rtol=0,
                                   err_msg=f"level {lvl}")


@pytest.mark.parametrize("multi_anchor", [False, True])
def test_gt_creator_equal(multi_anchor):
    """Random boxes over a batch of 3 (some under 1 px, some off the grid,
    padding rows), and LABELS: every element equal."""
    rng = np.random.default_rng(7)
    labels = np.zeros((3, 12, 5), np.float32)
    for n in range(3):
        k = 6 + 2 * n
        labels[n, :k] = np.concatenate([
            rng.integers(0, 2, (k, 1)), rng.uniform(-4, 70, (k, 2)),
            rng.uniform(0.2, 80, (k, 2))], 1)
    for lab in (labels, LABELS):
        got = _gt(lab, multi_anchor=multi_anchor)
        want = jy.gt_creator(S, jy.STRIDES, lab, multi_anchor=multi_anchor)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert _gt(multi_anchor=multi_anchor)[..., 0].sum() > 0


@pytest.mark.parametrize("hw", [(4, 6), (5, 7), (1, 3)])
def test_bilinear_upsample_matches_jax(hw):
    x = np.random.default_rng(8).normal(size=(2, *hw, 3)).astype(np.float32)
    got = ty.upsample_bilinear_2x_aligned(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = jy.upsample_bilinear_2x_aligned(jnp.asarray(x))
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_yolo_fpn_matches_flax():
    """pafpn.YOLOFPN (nearest upsample, lrelu BaseConvs) over Darknet-53's
    channels at strides 8 / 16 / 32 of a 64x64 input."""
    rng = np.random.default_rng(9)
    feats = [rng.normal(size=(1, 8 // 2 ** i, 8 // 2 ** i, c)).astype(
        np.float32) for i, c in enumerate((256, 512, 1024))]
    jm = JYOLOFPN()
    variables = seeded_variables(jm, np.random.default_rng(0),
                                 [jnp.asarray(f) for f in feats], False)
    tm = load_flax_variables(YOLOFPN(), variables).eval()
    want = jax.jit(lambda v, fs: jm.apply(v, fs, False))(
        variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def one_stream_tree(tmp_path_factory):
    """A one-stream 120x152 tree's EV and TAF blobs at a square 64x64
    input: three samples a split."""
    return synthetic.build_mini_gen1(
        str(tmp_path_factory.mktemp("data")), np.random.default_rng(1),
        streams=("seq0",), sensor_hw=(120, 152), input_hw=(S, S))


@pytest.mark.parametrize("exp_type,bins,blobs,model,losses", [
    ("yolov3", 5, "ev_dir", "YOLOv3Detector", V3_LOSSES),
    ("yolov3_taf_bfm", 8, "taf_dir", "YOLOv3Detector", V3_LOSSES),
    ("red", 5, "ev_dir", "REDDetector", RED_LOSSES),
    ("convlstm", 5, "ev_dir", "MemoryEventDetector", AED_LOSSES),
    ("recconv", 5, "ev_dir", "MemoryEventDetector", AED_LOSSES)])
def test_clis_train_and_test(one_stream_tree, tmp_path, exp_type, bins,
                             blobs, model, losses):
    """cli.train then cli.test for each exp type of this slice on the CPU
    at a square 64x64, the config's model at its full width: the Trainer
    builds the family's detector (the BFM stem for yolov3_taf_bfm), runs
    one epoch (one step at batch 2; yolov3 on gt_creator's targets) with
    every loss finite, writes best_epoch and the backbone part, and
    cli.test on a fresh Trainer (resume_exp) scores best_epoch: six
    finite stats."""
    tree = one_stream_tree
    common = ["--exp_type", exp_type, "--dataset", "gen1",
              "--event_volume_bins", str(bins), "--data_path", tree[blobs],
              "--bbox_path", tree["labels"], "--log_path",
              str(tmp_path / "log"), "--device", "cpu", "--img_size",
              str(S), str(S), "--sensor_hw", "120", "152", "--batch_size",
              "2", "--num_cpu_workers", "1"]
    try:
        trainer = cli_train.main(common + [
            "--exp_name", "run", "--augmentation", "False",
            "--max_epoch_to_stop", "1"])
        assert type(trainer.model).__name__ == model
        if model == "YOLOv3Detector":
            assert hasattr(trainer.model.backbone, "layer_1") == (bins == 8)
            assert trainer.history[0]["gt_creator_s"] > 0
        hist = trainer.history[0]
        assert hist["steps"] == 1
        assert all(np.isfinite(v) for lo in hist["losses"]
                   for v in lo.values())
        assert set(hist["losses"][0]) == losses
        ckpt = tmp_path / "log" / "run" / "checkpoints"
        assert (ckpt / "best_epoch").exists()
        assert (ckpt / "last_epoch_backbone.pth").exists()
        stats = cli_test.main(common + ["--resume_exp", "run"])
        assert len(stats) == 6 and all(np.isfinite(stats))
    finally:
        # the full-width checkpoints: 1.6 GB for yolov3, 0.5-0.7 GB else
        shutil.rmtree(tmp_path / "log", ignore_errors=True)
