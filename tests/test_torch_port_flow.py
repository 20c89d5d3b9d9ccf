"""The port's motion-level flow against the JAX tool's, on the CPU:
tools/motion_level.py's generate_timesurface equals JAX's exactly on the
mini tree's windows (tests/fixtures.py, 60x76) and on a GEN1-size tree's
(240x304, where the pyramid has three levels); tools/farneback.py against
JAX's compute_flow (cv2.calcOpticalFlowFarneback, cv2.optflow absent) on
those surface pairs and on a smooth seeded texture shifted by
(1.5, -0.75) px: endpoint error mean <= 0.01 px and 99th percentile <=
0.1 px, both medians within 0.05 px of the shift 20 px from the edges;
every fixture box's box_flow_density within 2% of the cv2 flow's, in the
same quintile unless cv2's density lies within 2% of a bound."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from frlw_evd_tpu_torch.data import synthetic  # noqa: E402
from frlw_evd_tpu_torch.events import PSEELoader  # noqa: E402
from frlw_evd_tpu_torch.events.npy_codec import load_bboxes  # noqa: E402
from frlw_evd_tpu_torch.tools import farneback, motion_level  # noqa: E402
from frlw_evd_tpu_torch.tools.generate_common import events_to_xytp  # noqa: E402,E501
from frlw_evd_tpu_torch.tools.generate_opticalflow import WINDOW  # noqa: E402,E501

ROOT = Path(__file__).resolve().parent.parent
EPE_MEAN, EPE_P99, SHIFT_TOL, DENSITY_REL = 0.01, 0.1, 0.05, 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process while the file runs (the suite's
    other workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jml():
    """The JAX root tool's motion_level module (numpy and cv2)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import motion_level as jml
    finally:
        sys.path.pop(0)
    assert not hasattr(cv2, "optflow")    # so compute_flow is Farneback
    return jml


def _pairs(tree, sensor):
    """[(stream, t, xytp, boxes at t)] of the tree's test split, the
    windows generate_opticalflow cuts."""
    out = []
    for ev_path in sorted(Path(tree["events"], "test").glob("*_td.dat")):
        name = ev_path.name[:-len("_td.dat")]
        boxes = load_bboxes(str(Path(tree["labels"], "test",
                                     f"{name}_bbox.npy")))
        loader = PSEELoader(str(ev_path))
        for t in np.unique(boxes["t"]):
            loader.seek_time(int(t) - WINDOW)
            xytp = events_to_xytp(loader.load_delta_t(WINDOW))
            xytp = xytp[(xytp[:, 0] < sensor[1]) & (xytp[:, 1] < sensor[0])]
            out.append((name, int(t), xytp, boxes[boxes["t"] == t]))
    return out


@pytest.fixture(scope="module")
def surfaces(jml, tmp_path_factory):
    """[(sensor, box rows, JAX's uint8 surfaces, the port's)] of the 6 mini
    pairs and 3 pairs of one GEN1-size stream; the surfaces checked equal
    to JAX's exactly on the way."""
    out = []
    for sensor, kw in (((60, 76), {}),
                       ((240, 304), dict(streams=("g0",),
                                         sensor_hw=(240, 304),
                                         input_hw=(256, 320), blobs=()))):
        tree = synthetic.build_mini_gen1(
            str(tmp_path_factory.mktemp(f"tree{sensor[0]}")),
            np.random.default_rng(0 if sensor[0] == 60 else 1),
            splits=("test",), **kw)
        for name, t, xytp, boxes in _pairs(tree, sensor):
            j1, j2 = jml.generate_timesurface(xytp, sensor)
            p1, p2 = motion_level.generate_timesurface(xytp, sensor, "cpu")
            assert p1.dtype == torch.float64
            np.testing.assert_array_equal(p1.numpy(), j1, err_msg=name)
            np.testing.assert_array_equal(p2.numpy(), j2, err_msg=name)
            j = (j1.astype(np.uint8), j2.astype(np.uint8))
            p = (p1.to(torch.uint8).numpy(), p2.to(torch.uint8).numpy())
            np.testing.assert_array_equal(p[0], j[0])
            np.testing.assert_array_equal(p[1], j[1])
            out.append((sensor, boxes, j))
    assert len(out) == 9
    return out


def test_timesurface_of_no_events_is_zero():
    v1, v2 = motion_level.generate_timesurface(np.zeros((0, 4)), (5, 7),
                                               "cpu")
    assert not v1.any() and not v2.any() and v1.shape == (5, 7)


def _epe(a, b):
    return np.sqrt(((a - b) ** 2).sum(-1))


def test_pyramid_levels():
    assert [lv[0] for lv in farneback.pyramid(240, 304)] == [
        (60, 76), (120, 152), (240, 304)]
    assert [lv[0] for lv in farneback.pyramid(60, 76)] == [(60, 76)]
    assert [lv[2] for lv in farneback.pyramid(240, 304)] == [9, 3, 3]
    for n, sigma in ((3, 0.0), (3, 0.5), (9, 1.5), (19, 3.5)):
        np.testing.assert_allclose(
            farneback.gaussian_kernel(n, sigma),
            cv2.getGaussianKernel(n, sigma).ravel(), rtol=1e-6)


def test_flow_matches_cv2_on_surfaces(jml, surfaces):
    epes = []
    for sensor, _, (prev, curr) in surfaces:
        want = jml.compute_flow(prev, curr)
        got = motion_level.compute_flow(prev, curr, "cpu")
        assert got.shape == (*sensor, 2) and got.dtype == np.float32
        epes.append(_epe(got, want).ravel())
    epe = np.concatenate(epes)
    print(f"Farneback against cv2 on {len(surfaces)} surface pairs: "
          f"endpoint error mean {epe.mean():.3e} px, 99th percentile "
          f"{np.quantile(epe, 0.99):.3e}, max {epe.max():.3e}")
    assert epe.mean() <= EPE_MEAN and np.quantile(epe, 0.99) <= EPE_P99, \
        (epe.mean(), np.quantile(epe, 0.99))


def _texture(rng, shape, shift):
    from scipy import ndimage

    H, W = shape
    base = ndimage.gaussian_filter(rng.standard_normal((H + 40, W + 40)), 3)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    moved = ndimage.shift(base, (shift[1], shift[0]), order=3)
    return (base[20:20 + H, 20:20 + W].astype(np.uint8),
            np.clip(moved[20:20 + H, 20:20 + W], 0, 255).astype(np.uint8))


def test_flow_matches_cv2_on_shifted_texture(jml):
    shift = (1.5, -0.75)
    prev, curr = _texture(np.random.default_rng(0), (240, 304), shift)
    want = jml.compute_flow(prev, curr)
    got = farneback.farneback_flow(torch.from_numpy(prev),
                                   torch.from_numpy(curr), "cpu").numpy()
    epe = _epe(got, want)
    meds = [np.median(f[20:-20, 20:-20].reshape(-1, 2), 0)
            for f in (got, want)]
    print(f"Farneback against cv2 on the texture shifted by {shift}: "
          f"endpoint error mean {epe.mean():.3e} px, max {epe.max():.3e}; "
          f"medians {meds[0]} (port), {meds[1]} (cv2)")
    assert epe.mean() <= EPE_MEAN and np.quantile(epe, 0.99) <= EPE_P99
    for med in meds:
        assert np.abs(med - shift).max() <= SHIFT_TOL, med


def _quintile(density, bounds):
    return int(np.searchsorted(bounds, density, side="right")) - 1


def test_box_densities_and_quintiles_match_cv2(jml, surfaces):
    bounds = motion_level.PERCENTILES["gen1"]
    n = 0
    for sensor, boxes, (prev, curr) in surfaces:
        want = jml.compute_flow(prev, curr)
        got = motion_level.compute_flow(prev, curr, "cpu")
        for b in boxes:
            row = np.array([b["t"], b["x"], b["y"], b["w"], b["h"]],
                           np.float64)
            x1, y1, x2, y2 = motion_level.clip_box_xywh(row, sensor)
            dw = jml.box_flow_density(want, x1, y1, x2, y2)
            dg = motion_level.box_flow_density(got, x1, y1, x2, y2)
            assert abs(dg - dw) <= DENSITY_REL * dw + 1e-9, (dg, dw)
            near = any(abs(dw - q) <= DENSITY_REL * q for q in bounds[1:-1])
            assert near or _quintile(dg, bounds) == _quintile(dw, bounds)
            n += 1
    assert n == 18
