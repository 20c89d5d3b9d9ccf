"""The port's COCO evaluation (frlw_evd_tpu_torch/evaluate) against the
JAX package's on random ground truth and detections from a numpy seed:
COCOMeanAP, evaluate_detection, the Evaluator (with its first-batch time
skip, its track-id filter and its all-zero placeholder row), the
Recorder and the folder evaluator. Gate: the six stats within 1e-12 (both
are float64 numpy over the same rows)."""

from __future__ import annotations

import numpy as np
import pytest

from frlw_evd_tpu.evaluate import coco_eval as j_coco_eval
from frlw_evd_tpu.evaluate import coco_map as j_coco_map
from frlw_evd_tpu.evaluate import evaluator as j_evaluator
from frlw_evd_tpu.evaluate import psee_evaluator as j_psee
from frlw_evd_tpu.evaluate.box_filtering import filter_boxes_gen1 as j_filter
from frlw_evd_tpu.events.box_loading import array_to_boxes
from frlw_evd_tpu_torch.evaluate import box_filtering as t_filtering
from frlw_evd_tpu_torch.evaluate import coco_eval as t_coco_eval
from frlw_evd_tpu_torch.evaluate import coco_map as t_coco_map
from frlw_evd_tpu_torch.evaluate import evaluator as t_evaluator
from frlw_evd_tpu_torch.evaluate import psee_evaluator as t_psee

TOL = 1e-12


def _rows(rng, n, t, nc=2, jitter_of=None):
    """(n, 8) Prophesee rows at time t; near `jitter_of`'s boxes when
    given (detections that partly match)."""
    out = np.zeros((n, 8))
    out[:, 0] = t
    if jitter_of is not None and len(jitter_of):
        src = jitter_of[rng.integers(0, len(jitter_of), n)]
        out[:, 1:5] = src[:, 1:5] + rng.normal(0, 4, (n, 4))
        out[:, 5] = np.where(rng.random(n) < 0.85, src[:, 5],
                             rng.integers(0, nc, n))
    else:
        out[:, 1:3] = rng.uniform(0, 250, (n, 2))
        out[:, 3:5] = rng.uniform(8, 140, (n, 2))
        out[:, 5] = rng.integers(0, nc, n)
    out[:, 3:5] = np.abs(out[:, 3:5]) + 1
    out[:, 6] = rng.integers(1, 50, n)
    out[:, 7] = rng.uniform(0, 1, n)
    return out


def _images(seed, n_img=30):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for i in range(n_img):
        gt = _rows(rng, int(rng.integers(0, 7)), 600_000 + 10_000 * i)
        dt = np.concatenate([
            _rows(rng, int(rng.integers(0, 8)), gt[0, 0] if len(gt) else 0,
                  jitter_of=gt),
            _rows(rng, int(rng.integers(0, 4)), gt[0, 0] if len(gt) else 0)])
        gts.append(gt)
        dts.append(dt)
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_coco_mean_ap_equals_jax(seed):
    gts, dts = _images(seed)
    t, j = t_coco_map.COCOMeanAP(2), j_coco_map.COCOMeanAP(2)
    for g, d in zip(gts, dts):
        t.add_image(g, d)
        j.add_image(g, d)
    got, want = np.array(t.summarize()), np.array(j.summarize())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got > -1).any()
    a, b = gts[3][:, 1:5], dts[3][:, 1:5]
    np.testing.assert_array_equal(t_coco_map.iou_xywh(b, a),
                                  j_coco_map.iou_xywh(b, a))


def _streams(seed, n_files=3):
    """Per file time-sorted GT and DT rows over several timestamps, DTs
    within and outside the ±tolerance of each GT time."""
    rng = np.random.default_rng(seed)
    gt_list, dt_list = [], []
    for _ in range(n_files):
        gts, dts = [], []
        for k in range(12):
            t = 550_000 + 50_000 * k
            gt = _rows(rng, int(rng.integers(1, 5)), t)
            dt = _rows(rng, int(rng.integers(0, 7)),
                       t + rng.integers(-8000, 8000), jitter_of=gt)
            gts.append(gt)
            dts.append(dt)
        gt_list.append(np.concatenate(gts))
        dt = np.concatenate(dts)
        dt_list.append(dt[np.argsort(dt[:, 0], kind="stable")])
    return gt_list, dt_list


@pytest.mark.parametrize("seed,time_tol", [(0, 4999), (1, 50_000),
                                           (2, 4999)])
def test_evaluate_detection_equals_jax(seed, time_tol):
    gts, dts = _streams(seed)
    got = t_coco_eval.evaluate_detection(gts, dts, time_tol=time_tol)
    want = j_coco_eval.evaluate_detection(gts, dts, time_tol=time_tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for g in gts:
        np.testing.assert_array_equal(t_filtering.filter_boxes_gen1(g),
                                      j_filter(g))


def _eval_batches(seed, n_batches=5, batch=4, nc=2):
    """Evaluator inputs: per batch the (n, 6) detections [cx, cy, w, h,
    cls, score] of each image (some empty, as finalize_detections' zero
    row), the window times, (batch, 80, 8) eval labels [cx, cy, w, h, cls,
    t, track, conf] padded with zero rows, names and timings."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        labels = np.zeros((batch, 80, 8), np.float32)
        dets, tss = [], []
        for i in range(batch):
            t = 600_000 + 10_000 * (b * batch + i)
            g = int(rng.integers(0, 5))
            cx, cy = rng.uniform(30, 220, g), rng.uniform(30, 220, g)
            w, h = rng.uniform(12, 90, g), rng.uniform(12, 90, g)
            labels[i, :g] = np.stack([cx, cy, w, h, rng.integers(0, nc, g),
                                      np.full(g, t), rng.integers(1, 9, g),
                                      np.ones(g)], -1)
            n = int(rng.integers(0, 6))
            if n == 0:
                d = np.zeros((1, 6), np.float32)
            else:
                src = labels[i, rng.integers(0, max(g, 1), n)]
                d = np.concatenate([src[:, :4] + rng.normal(0, 3, (n, 4)),
                                    rng.integers(0, nc, (n, 1)),
                                    rng.uniform(0.3, 1, (n, 1))],
                                   1).astype(np.float32)
            dets.append(d)
            tss.append(t)
        out.append((dets, tss, labels, [f"s{b % 2}"] * batch,
                    float(rng.uniform(0.01, 0.02)), 0.0))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_and_recorder_equal_jax(seed, tmp_path, capsys):
    geometry = ((("car", "pedestrian"), 4, 10000, 304, 240, 320, 256, "gen1"))
    paths = {"port": tmp_path / "t", "jax": tmp_path / "j"}
    for p in paths.values():
        p.mkdir()
    evs = {"port": t_evaluator.Evaluator(
               *geometry, recorder=t_evaluator.Recorder(str(paths["port"]))),
           "jax": j_evaluator.Evaluator(
               *geometry, recorder=j_evaluator.Recorder(str(paths["jax"])))}
    for batch in _eval_batches(seed):
        for ev in evs.values():
            ev.add_result(*batch)
    got, want = evs["port"].evaluate(), evs["jax"].evaluate()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.max(got) > 0
    for key in ("infer_time", "infer_count", "tol"):
        assert getattr(evs["port"], key) == getattr(evs["jax"], key)
    assert evs["port"].infer_count == 4     # the first batch is not timed
    for g, w in zip(evs["port"].dt_to_eval, evs["jax"].dt_to_eval):
        np.testing.assert_array_equal(g, w)
    t_sum = np.load(paths["port"] / "summarise.npz")
    j_sum = np.load(paths["jax"] / "summarise.npz")
    np.testing.assert_array_equal(t_sum["dts"], j_sum["dts"])
    np.testing.assert_array_equal(t_sum["file_names"], j_sum["file_names"])


def test_psee_folder_evaluator_equals_jax(tmp_path):
    gts, dts = _streams(5)
    for sub, rows in (("gt", gts), ("dt", dts)):
        (tmp_path / sub).mkdir()
        for i, r in enumerate(rows):
            np.save(tmp_path / sub / f"f{i}_bbox.npy", array_to_boxes(r))
    args = (str(tmp_path / "dt"), str(tmp_path / "gt"), 4999, "gen1")
    got = t_psee.evaluate_folders(*args)
    want = j_psee.evaluate_folders(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.max(got) > -1
