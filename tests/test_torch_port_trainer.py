"""The port's Trainer (frlw_evd_tpu_torch/train/trainer.py) against the JAX
package's on the CPU: evaluation, seq-NMS and the EMA, on the synthetic
tree of test_torch_port_trainer_common.py.

Both Trainers build a narrow AED (32 wide, stem bfm); the port's takes
JAX's variables through weights.load_flax_variables. Gates: each window's
detections, as the Evaluator holds them, within 1e-4 of JAX's (measured
about 1e-5: f32 convolutions in another order); the COCO stats within
1e-3; and the two Evaluators fed the port's detections within 1e-12.
Also: seq-NMS alike, finalize_detections, and test() under the EMA. The
epoch and resume, the patchified epoch and the families are in
test_torch_port_trainer_{epoch,patchified,families}.py.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from frlw_evd_tpu.models.seq_nms import SeqNMSState as JSeqNMSState
from frlw_evd_tpu.models.seq_nms import seq_nms as j_seq_nms
from frlw_evd_tpu.models.postprocess import \
    finalize_detections as j_finalize_detections
from frlw_evd_tpu_torch.models.seq_nms import SeqNMSState, seq_nms
from frlw_evd_tpu_torch.models.postprocess import finalize_detections
from frlw_evd_tpu_torch.train import load_checkpoint

from test_torch_port_trainer_common import (  # noqa: F401 (fixtures)
    DET_TOL, SAME_DETS_TOL, STATS_TOL, _match, _small_trainer, _Tee, pair,
    tree)


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
