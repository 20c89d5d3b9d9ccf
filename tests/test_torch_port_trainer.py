"""The port's Trainer (frlw_evd_tpu_torch/train/trainer.py) against the JAX
package's, on the CPU, on a synthetic tree at twice the mini fixture's
scale (120x152 sensor, 128x160 input: at 60x76 the GEN1 evaluation filter
drops every box, so the COCO stats would all be -1).

Both Trainers build a narrow AED (32 wide, stem bfm); the port's takes
JAX's variables through weights.load_flax_variables. The variables are
JAX's init with BatchNorm scales U(1, 1.25) and biases N(0, 0.1), the obj
biases 2.0 and the box-size biases log 8, so that boxes pass conf 0.3, of
a size the GEN1 filter keeps, and some overlap the ground truth. Gates:
each window's detections, as the Evaluator holds them, within 1e-4 of
JAX's (measured about 1e-5: f32 convolutions in another order); the COCO
stats within 1e-3; and the two Evaluators fed the port's detections within
1e-12. Also: seq-NMS alike, finalize_detections, one train epoch with
checkpoint resume and the EMA, the backbone part, the model of each
family, the refusals and the device rule.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as j_build_detector
from frlw_evd_tpu.models.seq_nms import SeqNMSState as JSeqNMSState
from frlw_evd_tpu.models.seq_nms import seq_nms as j_seq_nms
from frlw_evd_tpu.models.postprocess import \
    finalize_detections as j_finalize_detections
from frlw_evd_tpu.train import Trainer as JTrainer
from frlw_evd_tpu.train import make_config as j_make_config
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.seq_nms import SeqNMSState, seq_nms
from frlw_evd_tpu_torch.models.postprocess import finalize_detections
from frlw_evd_tpu_torch.train import (Trainer, load_checkpoint,
                                      load_pretrained_backbone, make_config)
from frlw_evd_tpu_torch.weights import load_flax_variables

SENSOR, INPUT = (120, 152), (128, 160)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
DET_TOL, STATS_TOL, SAME_DETS_TOL = 1e-4, 1e-3, 1e-12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.build_mini_gen1(
        str(tmp_path_factory.mktemp("tree")), np.random.default_rng(0),
        sensor_hw=SENSOR, input_hw=INPUT, blobs=("taf",))


def _cfg_kw(tree, log_path, **kw):
    return {**dict(dataset="gen1", batch_size=2, num_workers=1,
                   event_volume_bins=8, augmentation=False,
                   half_precision=False, img_size_override=INPUT,
                   sensor_hw_override=SENSOR, data_path=tree["taf_dir"],
                   bbox_path=tree["labels"], log_path=str(log_path)), **kw}


def _port_model(**kw):
    return build_detector(2, stem="bfm", train=True, dropout_rate=0.0,
                          **NARROW, **kw)


def _serving_params(params, rng):
    flat = {}
    for path, a in flatten_dict(jax.tree.map(np.array, params)).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 1.25, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = 2.0
        elif path[-2].startswith("reg_preds_") and path[-1] == "bias":
            a[:] = [0.0, 0.0, np.log(8.0), np.log(8.0)]
        flat[path] = a
    return unflatten_dict(flat)


@pytest.fixture(scope="module")
def pair(tree, tmp_path_factory):
    """(JAX Trainer, port Trainer) built on the tree, the port's weights
    carried from JAX's."""
    logs = tmp_path_factory.mktemp("logs")
    j_cfg = j_make_config("taf_bfm", exp_name="jax", **_cfg_kw(tree, logs))
    jt = JTrainer(j_cfg)
    jt.model = j_build_detector(2, stem="bfm", **NARROW)
    jt.create_datasets()
    jt.build(len(jt.train_loader))
    params = _serving_params(jt.state.params, np.random.default_rng(0))
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, params))

    pt = Trainer(make_config("taf_bfm", exp_name="port",
                             **_cfg_kw(tree, logs)), device="cpu")
    pt.model = _port_model()
    pt.create_datasets()
    pt.build(len(pt.train_loader))
    load_flax_variables(pt.model, {
        "params": params,
        "batch_stats": jax.tree.map(np.array, jt.state.batch_stats)})
    return jt, pt


class _Tee:
    """The port's Evaluator, with each add_result also made on a JAX
    Evaluator of the same geometry."""

    def __init__(self, port, jax_ev):
        self.port, self.jax = port, jax_ev

    def add_result(self, *args):
        self.port.add_result(*args)
        self.jax.add_result(*args)

    def evaluate(self):
        self.jax_stats = self.jax.evaluate()
        return self.port.evaluate()


def _match(got, want, tol):
    """Each row of want within tol of a distinct row of got."""
    assert len(got) == len(want)
    free = list(range(len(got)))
    for row in want:
        err = [np.abs(got[j] - row).max() for j in free]
        assert err and min(err) <= tol, (row, min(err, default=None))
        free.pop(int(np.argmin(err)))


@pytest.mark.parametrize("seq", [False, True], ids=["plain", "seq_nms"])
def test_eval_epoch_matches_jax(pair, seq):
    jt, pt = pair
    jt.cfg.seq_nms = pt.cfg.seq_nms = seq
    j_ev = jt.make_evaluator()
    j_stats = np.array(jt.eval_epoch(j_ev))
    tee = _Tee(pt.make_evaluator(), jt.make_evaluator())
    p_stats = np.array(pt.eval_epoch(tee))
    p_ev = tee.port
    assert len(p_ev.dt_to_eval) == len(j_ev.dt_to_eval) == 6
    for g, w in zip(p_ev.dt_to_eval, j_ev.dt_to_eval):
        _match(g, w, DET_TOL)
    for g, w in zip(p_ev.gt_to_eval, j_ev.gt_to_eval):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(p_stats, j_stats, rtol=0, atol=STATS_TOL)
    np.testing.assert_allclose(p_stats, tee.jax_stats, rtol=0,
                               atol=SAME_DETS_TOL)
    assert p_stats[1] > 0          # some detections match the ground truth
    assert pt.last_eval["stats"] == tuple(p_stats)
    assert p_ev.infer_count == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_nms_equals_jax(seed):
    rng = np.random.default_rng(seed)
    # two frames, as SeqNMSState.link calls it (the keep mask indexes the
    # first frame's boxes)
    frames = [np.concatenate([rng.uniform(0, 40, (n, 2)),
                              rng.uniform(45, 90, (n, 2))], 1)
              for n in (6, 5)]
    scores = [rng.uniform(0, 1, len(f)) for f in frames]
    labels = [rng.integers(0, 2, len(f)) for f in frames]
    np.testing.assert_array_equal(seq_nms(frames, scores, labels),
                                  j_seq_nms(frames, scores, labels))
    t_state, j_state = SeqNMSState(), JSeqNMSState()
    for _ in range(4):
        n = int(rng.integers(0, 6))
        dets = np.concatenate([rng.uniform(20, 60, (n, 2)),
                               rng.uniform(10, 30, (n, 2)),
                               rng.integers(0, 2, (n, 1)),
                               rng.uniform(0.3, 1, (n, 1))], 1)
        np.testing.assert_array_equal(t_state.link(dets), j_state.link(dets))


def test_finalize_detections_equals_jax():
    rng = np.random.default_rng(0)
    dets = rng.uniform(0, 50, (3, 10, 6)).astype(np.float32)
    keep = rng.random((3, 10)) < 0.4
    keep[1] = False
    got = finalize_detections(torch.from_numpy(dets), torch.from_numpy(keep))
    want = j_finalize_detections(dets, keep)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], np.zeros((1, 6), np.float32))


def _small_trainer(tree, log_path, name, exp_type="taf_bfm", model=None,
                   **kw):
    trainer = Trainer(make_config(exp_type, exp_name=name,
                                  **_cfg_kw(tree, log_path, **kw)),
                      device="cpu")
    trainer.model = model or _port_model(
        generator=torch.Generator().manual_seed(0))
    return trainer


def _one_epoch(trainer):
    """train() for one epoch; checks what it ran and wrote, returns the
    epoch's history entry."""
    trainer.train()
    assert [h["epoch"] for h in trainer.history] == [0]
    hist = trainer.history[0]
    assert hist["steps"] == 3
    assert all(np.isfinite(v) for lo in hist["losses"] for v in lo.values())
    assert len(hist["val"]["stats"]) == 6
    for name in ("last_epoch", "best_epoch"):
        assert os.path.exists(os.path.join(trainer.ckpt_dir, name)), name
    return hist


@pytest.mark.parametrize("use_ema", [False, True], ids=["masters", "ema"])
def test_train_epoch_and_resume(tree, tmp_path, use_ema):
    """One epoch (3 steps at batch 2) of train(), its checkpoints, then a
    resumed run from last_epoch: the epoch, the step count, the weights
    (and the EMA) picked up where they were."""
    first = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=1,
                           use_ema=use_ema)
    first.train()
    ckpt = tmp_path / "run" / "checkpoints"
    for name in ("last_epoch", "best_epoch", "last_epoch_backbone.pth",
                 "last_epoch_neck.pth"):
        assert (ckpt / name).exists(), name
    assert [h["epoch"] for h in first.history] == [0]
    hist = first.history[0]
    assert hist["steps"] == 3 and len(hist["losses"]) == 3
    assert all(np.isfinite(v) for lo in hist["losses"] for v in lo.values())
    assert 0 <= hist["loader_wait_s"] <= hist["wall_s"]
    assert len(hist["val"]["stats"]) == 6 and first.state.step == 3
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    ema = None if first.ema_params is None else {
        k: v.clone() for k, v in first.ema_params.items()}

    second = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=1,
                            use_ema=use_ema, resume_exp="run")
    second.create_datasets()
    second.build(len(second.train_loader))
    state, epoch, score = load_checkpoint(str(ckpt / "last_epoch"),
                                          second.state, second.ema_params)
    # last_epoch is saved before the epoch's validation, as in JAX
    assert epoch == 1 and state.step == 3 and score == -1.0
    for k, v in second.model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    if use_ema:
        for k, v in second.ema_params.items():
            torch.testing.assert_close(v, ema[k], rtol=0, atol=0)
        assert not torch.equal(ema["head.obj_preds_0.weight"],
                               saved["head.obj_preds_0.weight"])

    resumed = _small_trainer(tree, tmp_path, "run", max_epoch_to_stop=2,
                             use_ema=use_ema, resume_exp="run")
    resumed.train()
    assert [h["epoch"] for h in resumed.history] == [1]
    assert resumed.state.step == 6 and resumed.epoch == 2

    # the backbone part of the run directory's last save (the resumed run's)
    part = _small_trainer(tree, tmp_path, "part")
    part.build(1)
    load_pretrained_backbone(str(ckpt / "last_epoch_backbone"), part.state)
    want = resumed.model.backbone.state_dict()
    for k, v in part.model.backbone.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


@pytest.mark.parametrize("field,value,model", [
    ("family", "yolov3", "YOLOv3Detector"), ("family", "red", "REDDetector"),
    ("memory", "convlstm", "MemoryEventDetector")])
def test_trainer_builds_the_family(tree, tmp_path, field, value, model):
    """The Trainer builds the model of the config's family (JAX
    trainer.py:329-357): the yolov3 detector with the BFM stem for stem
    bfm, RED, the memory detector with ConvLSTM cells over in_channels."""
    cfg = make_config("taf_bfm", **_cfg_kw(tree, tmp_path))
    setattr(cfg, field, value)
    built = Trainer(cfg, device="cpu").model
    assert type(built).__name__ == model
    assert built.training
    if value == "yolov3":
        assert type(built.backbone.layer_1).__name__ == "BinsFusionModule"
    if value == "convlstm":
        assert built.memory.lstms_2.hidden_dim == cfg.in_channels[2]


def test_trainer_asks_for_the_card(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(make_config("taf_bfm", **_cfg_kw(tree, tmp_path)))
    assert not os.path.exists(tmp_path / "taf_bfm")


def test_trainer_trains_basic_on_port_made_ev_blobs(tree, tmp_path,
                                                    monkeypatch):
    """`basic` (aed, focus stem, 5 bins: 10 channels) over the Event
    Volume blobs of tools.generate_eventvolume, run on the tree at its
    120x152 → 128x160 geometry."""
    from frlw_evd_tpu_torch.tools import generate_common
    from frlw_evd_tpu_torch.tools.generate_eventvolume import \
        generate_eventvolume

    monkeypatch.setitem(generate_common.GEOMETRY, "tree",
                        dict(shape=SENSOR, target_shape=INPUT))
    out = str(tmp_path / "blobs")
    stats = generate_eventvolume(tree["events"], tree["labels"], out,
                                 "tree", "cpu")
    assert stats["blobs"] == 3 * 3 * 6        # splits x windows x times
    model = build_detector(2, stem="focus", input_channels=10, train=True,
                           generator=torch.Generator().manual_seed(0),
                           **NARROW)
    trainer = _small_trainer(tree, tmp_path, "basic", exp_type="basic",
                             model=model, event_volume_bins=5,
                             max_epoch_to_stop=1,
                             data_path=os.path.join(out, "EventVolume250000"))
    assert trainer.cfg.input_channels == 10
    _one_epoch(trainer)


def test_trainer_trains_yolox_taf_bfm(tree, tmp_path):
    """`yolox_taf_bfm`: the Trainer builds CSPDarknet with the bfm stem;
    one epoch on the TAF blobs with its head narrowed to 32."""
    cfg = make_config("yolox_taf_bfm", exp_name="built",
                      **_cfg_kw(tree, tmp_path))
    built = Trainer(cfg, device="cpu").model
    assert type(built.backbone).__name__ == "CSPDarknet"
    assert type(built.backbone.stem).__name__ == "BinsFusionModule"
    model = build_detector(2, family="yolox", stem="bfm", head_width=32,
                           dropout_rate=0.0, input_channels=16, train=True,
                           generator=torch.Generator().manual_seed(0))
    _one_epoch(_small_trainer(tree, tmp_path, "yolox",
                              exp_type="yolox_taf_bfm", model=model,
                              max_epoch_to_stop=1))


@pytest.mark.parametrize("exp_type,stem", [("taf_bfm", "BinsFusionModule"),
                                           ("basic", "FocusPatched")])
def test_trainer_builds_the_p64_stems(tree, tmp_path, exp_type, stem):
    cfg = make_config(exp_type, patchified=True, remat=True,
                      **_cfg_kw(tree, tmp_path))
    trainer = Trainer(cfg, device="cpu")
    assert type(trainer.model.backbone.stem).__name__ == (
        "BinsFusionModulePatched" if stem == "BinsFusionModule" else stem)


@pytest.mark.parametrize("field,value", [
    ("stem", "bfm_folded"), ("family", "yolov3"), ("family", "red"),
    ("memory", "convlstm")])
def test_trainer_refuses_patchified_without_a_p64_path(tree, tmp_path,
                                                       field, value):
    cfg = make_config("taf_bfm", patchified=True, **_cfg_kw(tree, tmp_path))
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match="patchified"):
        Trainer(cfg, device="cpu")


def test_trainer_patchified_epoch_equals_canonical(tree, tmp_path):
    """One epoch with patchified=True and remat=True (the bfm_p64 stem, the
    steps patchifying) from the canonical model's weights, dropout 0: each
    step's losses within rtol 2e-4 of the canonical epoch's."""
    canon = _port_model(generator=torch.Generator().manual_seed(0))
    p64 = build_detector(2, stem="bfm_p64", train=True, dropout_rate=0.0,
                         **NARROW)
    p64.load_state_dict(canon.state_dict())
    want = _one_epoch(_small_trainer(tree, tmp_path, "canon", model=canon,
                                     max_epoch_to_stop=1))
    got = _one_epoch(_small_trainer(tree, tmp_path, "p64", model=p64,
                                    max_epoch_to_stop=1, patchified=True,
                                    remat=True))
    for g, w in zip(got["losses"], want["losses"]):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=2e-4, err_msg=k)


def test_test_under_ema_scores_the_best_epoch(tree, tmp_path):
    """ROADMAP C: with use_ema, best_epoch holds the EMA parameters and
    test() scores them as saved, equal to eval_epoch on that checkpoint;
    the JAX Trainer would score a fresh EMA initialisation instead."""
    first = _small_trainer(tree, tmp_path, "ema", max_epoch_to_stop=1,
                           use_ema=True)
    first.train()
    ckpt = os.path.join(first.ckpt_dir, "best_epoch")
    best = torch.load(ckpt, weights_only=True)["model"]
    last = torch.load(os.path.join(first.ckpt_dir, "last_epoch"),
                      weights_only=True)["model"]
    assert not torch.equal(best["head.obj_preds_0.weight"],
                           last["head.obj_preds_0.weight"])

    tested = _small_trainer(tree, tmp_path, "ema", use_ema=True,
                            resume_exp="ema")
    stats = tested.test()
    assert tested.ema_params is None

    ref = _small_trainer(tree, tmp_path, "ref")
    ref.create_test_dataset()
    ref.build(1)
    load_checkpoint(ckpt, ref.state)
    for k, v in ref.model.state_dict().items():
        torch.testing.assert_close(v, best[k], rtol=0, atol=0, msg=k)
    want = ref.eval_epoch(ref.make_evaluator())
    np.testing.assert_array_equal(np.asarray(stats), np.asarray(want))
