"""The port's utilities against the JAX package's and OpenCV, on the CPU:
utils/metric.py's meters equal JAX's on the same sequences;
utils/demo_utils.py's nms and multiclass_nms keep what JAX's keep on
seeded boxes (ties at small N included) and the box converters equal
JAX's to 0 ulp; utils/profiling.py's Timer counts and totals and its
trace writes a file; utils/draw.py's JET and HSV tables within one level
per channel of cv2.applyColorMap for all 256 inputs, its rectangle and
nearest resize pixel for pixel cv2's, its PNGs read back by cv2.imread
equal to the array; evaluate/visualizations.py's renders within one level
of JAX's (its JET table's gate; the boxes exact); and every new module
imports, visualization and generate_opticalflow run, with cv2 blocked."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frlw_evd_tpu.utils import demo_utils as jdemo
from frlw_evd_tpu.utils import metric as jmetric
from frlw_evd_tpu_torch.utils import (AverageMeter, MeterBuffer, Timer,
                                      demo_utils, draw, trace)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process while the file runs: small ops
    stall on the thread pool's barriers when the suite's other workers
    hold every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meters_equal_jax():
    rng = np.random.default_rng(0)
    values = rng.normal(0, 3, 137).tolist() + [np.float32(2.5), 7]
    for window in (1, 5, 50):
        a, b = AverageMeter(window), jmetric.AverageMeter(window)
        for v in values:
            a.update(v)
            b.update(v)
            for prop in ("median", "avg", "global_avg", "latest", "total"):
                assert getattr(a, prop) == getattr(b, prop), prop
        a.clear()
        b.clear()
        assert (a.avg, a.latest, a.total) == (b.avg, b.latest, b.total)
        a.reset()
        b.reset()
        assert (a.global_avg, a.total) == (b.global_avg, b.total)
    pa, pb = MeterBuffer(7), jmetric.MeterBuffer(7)
    for i, v in enumerate(values):
        kw = {"loss": v, "iter_time": abs(v)}
        pa.update({"lr": torch.tensor(i / 10, dtype=torch.float64)}, **kw)
        pb.update({"lr": np.float64(i / 10)}, **kw)
    assert set(pa) == set(pb)
    for k in pa:
        assert (pa[k].avg, pa[k].median, pa[k].global_avg) == (
            pb[k].avg, pb[k].median, pb[k].global_avg), k
    assert set(pa.get_filtered_meter()) == set(pb.get_filtered_meter()) \
        == {"iter_time"}
    pa.clear_meters()
    pa.reset()
    assert all(m.total == 0.0 for m in pa.values())


def _boxes(rng, n, ties):
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(2, 20, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 3).astype(np.float32) / 3
        boxes[1::2] = boxes[0:-1:2] + 1     # overlapping pairs
    return boxes, scores


@pytest.mark.parametrize("n,ties", [(1, False), (6, True), (12, True),
                                    (40, False), (200, False)])
@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_nms_keeps_what_jax_keeps(n, ties, thr):
    boxes, scores = _boxes(np.random.default_rng(n), n, ties)
    got = demo_utils.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         thr)
    assert got == [int(i) for i in jdemo.nms(boxes, scores, thr)]


@pytest.mark.parametrize("agnostic", [False, True])
def test_multiclass_nms_equals_jax(agnostic):
    rng = np.random.default_rng(3)
    boxes, _ = _boxes(rng, 60, True)
    scores = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    scores[:, 1] = np.round(scores[:, 1] * 4) / 4
    got = demo_utils.multiclass_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.45, 0.2,
                                    class_agnostic=agnostic)
    want = jdemo.multiclass_nms(boxes, scores, 0.45, 0.2,
                                class_agnostic=agnostic)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert demo_utils.multiclass_nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.45, 1.0,
                                     class_agnostic=agnostic) is None
    assert jdemo.multiclass_nms(boxes, scores, 0.45, 1.0,
                                class_agnostic=agnostic) is None


@pytest.mark.parametrize("name", ["xyxy2xywh", "xyxy2cxcywh",
                                  "cxcywh2xyxy"])
def test_box_converters_equal_jax(name):
    boxes = np.random.default_rng(4).uniform(-5, 300, (50, 4)).astype(
        np.float32)
    got = getattr(demo_utils, name)(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, getattr(jdemo, name)(boxes))


def test_timer_and_trace(tmp_path):
    t = Timer()
    for _ in range(3):
        with t.span("a"):
            x = t.fence(torch.ones(64, 64) @ torch.ones(64, 64))
    with t.span("b"):
        pass
    assert t.counts == {"a": 3, "b": 1}
    assert t.totals["a"] > 0 and t.avg_ms("a") == pytest.approx(
        1000 * t.totals["a"] / 3)
    assert "a:" in t.report() and "b:" in t.report()
    assert float(x[0, 0]) == 64.0
    with trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    path = tmp_path / "tr" / "trace.json"
    assert path.exists() and path.stat().st_size > 0


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("name", ["JET", "HSV"])
def test_colormaps_within_one_level_of_cv2(cv2, name):
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             getattr(cv2, f"COLORMAP_{name}"))[:, 0]
    got = getattr(draw, f"COLORMAP_{name}")
    assert got.shape == (256, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    img = np.random.default_rng(0).integers(0, 256, (9, 7), dtype=np.uint8)
    np.testing.assert_array_equal(draw.apply_colormap(img, got), got[img])


def test_rectangle_and_resize_equal_cv2(cv2):
    rng = np.random.default_rng(5)
    for _ in range(200):
        a = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
        b = a.copy()
        p1 = tuple(int(v) for v in rng.integers(-15, 55, 2))
        p2 = tuple(int(v) for v in rng.integers(-15, 55, 2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.rectangle(a, p1, p2, color, 1)
        draw.rectangle(b, p1, p2, color)
        np.testing.assert_array_equal(b, a, err_msg=f"{p1} {p2}")
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for size in ((76, 60), (304, 240), (50, 33), (96, 64)):
        np.testing.assert_array_equal(
            draw.resize_nearest(img, size),
            cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


def test_png_round_trips_through_cv2(cv2, tmp_path):
    rng = np.random.default_rng(6)
    for shape in ((17, 23, 3), (31, 5)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = draw.write_png(str(tmp_path / f"{len(shape)}.png"), img)
        flag = cv2.IMREAD_COLOR if len(shape) == 3 else cv2.IMREAD_GRAYSCALE
        np.testing.assert_array_equal(cv2.imread(path, flag), img)
        np.testing.assert_array_equal(draw.read_png(path), img)


def test_put_text_draws_inside_its_box():
    img = np.zeros((20, 60, 3), np.uint8)
    draw.put_text(img, "car 0.93", (2, 10), (1, 2, 3))
    w, h = 8 * (draw.GLYPH_W + 1) - 1, draw.GLYPH_H
    ys, xs = np.nonzero(img[..., 0])
    assert len(ys) > 10
    assert ys.min() >= 10 - h + 1 and ys.max() <= 10
    assert xs.min() >= 2 and xs.max() < 2 + w
    assert (img[ys, xs] == (1, 2, 3)).all()


@pytest.mark.parametrize("renderer", ["visualize_volume", "visualize_taf"])
def test_visualizations_match_jax(cv2, renderer, tmp_path):
    """The renders of both packages read back by cv2.imread: within one
    level per channel (the JET table's gate), the boxes' pixels equal."""
    from frlw_evd_tpu.evaluate import visualizations as jvis
    from frlw_evd_tpu_torch.evaluate import visualizations as pvis

    rng = np.random.default_rng(7)
    vol = rng.uniform(0, 3, (16, 40, 56)).astype(np.float32)
    gt = np.array([[20, 15, 10, 8], [50, 30, 30, 30], [1, 1, 4, 4.5]])
    dt = np.array([[22, 17, 9, 9]])
    a = getattr(jvis, renderer)(vol, gt, dt, "s", str(tmp_path / "j"), 5e5)
    b = getattr(pvis, renderer)(torch.from_numpy(vol), gt, dt, "s",
                                str(tmp_path / "p"), 5e5)
    assert os.path.basename(a) == os.path.basename(b)
    ia, ib = cv2.imread(a).astype(int), cv2.imread(b).astype(int)
    assert np.abs(ia - ib).max() <= 1
    boxes = (ia == (0, 255, 0)).all(-1) | (ia == (0, 0, 255)).all(-1)
    assert boxes.sum() > 50
    np.testing.assert_array_equal(ib[boxes], ia[boxes])
    hook = pvis.Visualizer(str(tmp_path / "h"), pvis.visualize_taf)
    assert os.path.exists(hook(vol, gt, None, "s", 7))


def test_new_modules_run_without_cv2(tmp_path):
    """With cv2 blocked (sys.modules["cv2"] = None), every new module
    imports, and visualization and generate_opticalflow run on the mini
    tree on the CPU."""
    code = f"""
import sys
sys.modules["cv2"] = None
import importlib
for m in ("utils.metric", "utils.demo_utils", "utils.profiling",
          "utils.draw", "evaluate.visualizations", "tools.farneback",
          "tools.motion_level", "tools.generate_opticalflow",
          "tools.motion_level_statistics_gt",
          "tools.motion_level_statistics_dt",
          "tools.motion_level_evaluation", "tools.visualization",
          "tools.sampling_dataset", "tools.dress_rehearsal",
          "tools.learnability"):
    importlib.import_module("frlw_evd_tpu_torch." + m)
import numpy as np
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.tools import generate_opticalflow, visualization
p = synthetic.build_mini_gen1({str(tmp_path)!r}, streams=("seq0",),
                              splits=("test",), ann_times=(600000,),
                              blobs=("taf",))
n = generate_opticalflow.main(["-raw_dir", p["events"], "-label_dir",
                               p["labels"], "-dataset", "gen1_mini",
                               "-out_dir", {str(tmp_path / "flow")!r},
                               "-device", "cpu"])
assert n == 1, n
drawn = visualization.main(["-item", "seq0", "-end", "600000",
                            "-data_path", p["taf_dir"], "-bbox_path",
                            p["labels"], "-dataset", "gen1_mini",
                            "-result_path", {str(tmp_path / "viz")!r},
                            "-flow_dir", {str(tmp_path / "flow")!r}])
from frlw_evd_tpu_torch.utils.draw import read_png
img = read_png({str(tmp_path / "viz" / "seq0_600000_taf.png")!r})
assert img.shape == (60, 76, 3) and (img == drawn["image"]).all()
flow = read_png({str(tmp_path / "viz" / "seq0_600000_flow.png")!r})
assert (flow == drawn["flow"]).all()
assert "cv2" not in [k for k, v in sys.modules.items() if v is not None]
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-3000:]
