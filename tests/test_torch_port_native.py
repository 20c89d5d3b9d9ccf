"""The port's host C++ loader (frlw_evd_tpu_torch/utils/native.py) against
the JAX package's and against its own numpy fallbacks, on random inputs
from a numpy seed: IoU, the COCO matcher and the sequential TAF queue
oracle. The library builds into build/native; where g++ is present the
C++ form runs. Gates: IoU and the queue exact (the same C++ source, the
same operations), the fallback IoU within 1e-12 and its queue within 1e-5
(np.add.at sums in another order than the C++ loop), the matcher's codes
and counts exact."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from frlw_evd_tpu.utils import native as j_native
from frlw_evd_tpu_torch.utils import native as t_native


def _xyxy(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0.5, 30, (n, 2))], 1)


def test_library_builds_outside_the_source_tree():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the numpy fallbacks run")
    assert t_native.has_native()
    assert t_native.LIB_PATH.exists()
    assert "build" in t_native.LIB_PATH.parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_overlap_and_area_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _xyxy(rng, 37), _xyxy(rng, 23)
    got = t_native.compute_overlap(a, b)
    np.testing.assert_array_equal(got, j_native.compute_overlap(a, b))
    np.testing.assert_allclose(t_native.compute_overlap_py(a, b), got,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t_native.compute_area(a),
                                  j_native.compute_area(a))


def _coco_inputs(rng, n_img=12):
    dts, gts, d_off, g_off = [], [], [0], [0]
    for _ in range(n_img):
        g = rng.integers(0, 6)
        d = rng.integers(0, 9)
        gt = np.concatenate([rng.uniform(0, 60, (g, 2)),
                             rng.uniform(4, 120, (g, 2))], 1)
        # detections near the gts (some), the rest anywhere
        dt = np.concatenate([rng.uniform(0, 60, (d, 2)),
                             rng.uniform(4, 120, (d, 2))], 1)
        near = min(g, d)
        dt[:near] = gt[:near] + rng.normal(0, 3, (near, 4))
        dt[:, 2:] = np.abs(dt[:, 2:]) + 1
        dts.append(dt)
        gts.append(gt)
        d_off.append(d_off[-1] + d)
        g_off.append(g_off[-1] + g)
    rngs = np.array([[0, 1e10], [0, 32.0**2], [32.0**2, 96.0**2],
                     [96.0**2, 1e10]])
    return (np.concatenate(dts), np.array(d_off), np.concatenate(gts),
            np.array(g_off), np.linspace(0.5, 0.95, 10), rngs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_coco_match_equals_jax_and_fallback(seed):
    args = _coco_inputs(np.random.default_rng(seed))
    codes, npig = t_native.coco_match(*args)
    j_codes, j_npig = j_native.coco_match(*args)
    p_codes, p_npig = t_native.coco_match_py(*args)
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_array_equal(npig, j_npig)
    np.testing.assert_array_equal(codes, p_codes)
    np.testing.assert_array_equal(npig, p_npig)


@pytest.mark.parametrize("seed", [0, 1])
def test_event_queue_tensor_equals_jax_and_fallback(seed):
    rng = np.random.default_rng(seed)
    B, H, W, K, n_bins, n = 2, 12, 16, 8, 5, 3000
    ev = np.stack([rng.integers(0, B, n), rng.integers(0, W, n),
                   rng.integers(0, H, n), rng.uniform(0, 1, n),
                   rng.integers(0, 2, n), rng.integers(0, n_bins, n)],
                  1).astype(np.float64)
    ev = ev[np.argsort(ev[:, 5], kind="stable")]
    got = t_native.event_queue_tensor(ev, B, H, W, K, n_bins)
    np.testing.assert_array_equal(
        got, j_native.event_queue_tensor(ev, B, H, W, K, n_bins))
    np.testing.assert_allclose(
        t_native.event_queue_tensor_py(ev, B, H, W, K, n_bins), got,
        rtol=0, atol=1e-5)
