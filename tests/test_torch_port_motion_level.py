"""The port's motion-level chain and dataset tools against the JAX root
tools (tools/*.py, imported as tests/test_dress_rehearsal.py imports
them), on the CPU, on the mini tree (tests/fixtures.py geometry): the
port's generate_opticalflow writes one (H, W, 2) f32 file an annotation;
on the SAME flow files motion_level_statistics_gt and _dt write what
JAX's write (names, rows, densities exactly) and motion_level_evaluation
prints the same 5 quintile values (to 1e-12, nan where JAX has nan);
sampling_dataset's .dat and _bbox.npy equal the JAX tool's byte for byte
(the .dat header's date line aside); visualization's flow PNG equals the
JAX tool's pixel for pixel and its representation image is within one
level of it outside the label text."""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.evaluate.evaluator import Recorder
from frlw_evd_tpu_torch.events import PSEELoader
from frlw_evd_tpu_torch.events.npy_codec import load_bboxes
from frlw_evd_tpu_torch.tools import (generate_opticalflow,
                                      motion_level_evaluation,
                                      motion_level_statistics_dt,
                                      motion_level_statistics_gt,
                                      sampling_dataset, visualization)
from frlw_evd_tpu_torch.utils import draw

ROOT = Path(__file__).resolve().parent.parent
EXP = "mini_exp"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process while the file runs (the suite's
    other workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _run_jax(monkeypatch, name, *argv):
    tool = _jax_tool(name)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return tool.main()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The mini tree's test split, its events and labels also merged in one
    directory (the layout of the statistics tools and sampling_dataset),
    the port's flow files and a recorded detection dump."""
    root = tmp_path_factory.mktemp("motion")
    paths = synthetic.build_mini_gen1(str(root / "t"), splits=("test",),
                                      blobs=("taf",))
    merged = root / "merged" / "test"
    merged.mkdir(parents=True)
    for d in (paths["events"], paths["labels"]):
        for f in os.listdir(os.path.join(d, "test")):
            os.symlink(os.path.join(d, "test", f), merged / f)
    flow = str(root / "flow")
    assert generate_opticalflow.main(
        ["-raw_dir", paths["events"], "-label_dir", paths["labels"],
         "-dataset", "gen1_mini", "-out_dir", flow, "-device", "cpu"]) == 6
    assert generate_opticalflow.main(
        ["-raw_dir", paths["events"], "-label_dir", paths["labels"],
         "-dataset", "gen1_mini", "-out_dir", flow, "-device", "cpu"]) == 0
    # noisy detections of the GT boxes, plus misses and false alarms
    rng = np.random.default_rng(1)
    (root / "log" / EXP).mkdir(parents=True)
    rec = Recorder(str(root / "log" / EXP))
    for stream in ("seq0", "seq1"):
        b = load_bboxes(os.path.join(paths["labels"], "test",
                                     f"{stream}_bbox.npy"))
        dt = np.zeros((len(b) + 2, 8))
        dt[:len(b), 0] = b["t"] + rng.integers(-3000, 3000, len(b))
        for j, f in enumerate(("x", "y", "w", "h")):
            dt[:len(b), 1 + j] = b[f] + rng.normal(0, 1.5, len(b))
        dt[:len(b), 5] = b["class_id"]
        dt[len(b):, 0] = b["t"][:2]
        dt[len(b):, 1:5] = [[50, 5, 8, 8], [3, 40, 10, 6]]
        dt[:, 7] = rng.uniform(0.3, 1.0, len(dt))
        rec.record(dt, stream)
    rec.save()
    return dict(paths=paths, merged=str(merged.parent), flow=flow,
                log=str(root / "log") + "/", root=root)


def test_flow_files(tree):
    files = sorted(os.listdir(tree["flow"]))
    assert len(files) == 6
    flow = np.load(os.path.join(tree["flow"], files[0]))
    assert flow.shape == (60, 76, 2) and flow.dtype == np.float32
    assert np.isfinite(flow).all() and np.abs(flow).max() > 0


def _npz_equal(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_statistics_and_evaluation_equal_jax(tree, monkeypatch, capsys):
    common = ["-raw_dir", tree["merged"], "-dataset", "gen1_mini",
              "-flow_dir", tree["flow"]]
    stats = {d: str(tree["root"] / f"stats_{d}") for d in ("jax", "port")}
    _run_jax(monkeypatch, "motion_level_statistics_gt", *common,
             "-out_dir", stats["jax"])
    jax_gt_line = capsys.readouterr().out.splitlines()[0]
    motion_level_statistics_gt.main(common + ["-out_dir", stats["port"]])
    assert capsys.readouterr().out.splitlines()[0] == jax_gt_line
    _npz_equal(os.path.join(stats["jax"], "gt_gen1_mini.npz"),
               os.path.join(stats["port"], "gt_gen1_mini.npz"))
    gt = np.load(os.path.join(stats["port"], "gt_gen1_mini.npz"))
    assert len(gt["densitys"]) == 12

    dt_args = common + ["-exp_name", EXP, "-log_path", tree["log"]]
    out = os.path.join(tree["log"], EXP, "summarise_stats.npz")
    _run_jax(monkeypatch, "motion_level_statistics_dt", *dt_args)
    os.rename(out, out + ".jax.npz")
    motion_level_statistics_dt.main(dt_args)
    _npz_equal(out + ".jax.npz", out)
    assert len(np.load(out)["densitys"]) > 0

    ev_args = ["-dataset", "gen1_mini", "-exp_name", EXP, "-log_path",
               tree["log"]]
    want = _run_jax(monkeypatch, "motion_level_evaluation", *ev_args,
                    "-stats_dir", stats["jax"])
    capsys.readouterr()
    got = motion_level_evaluation.main(ev_args + ["-stats_dir",
                                                  stats["port"]])
    last = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[")][-1]
    assert len(got) == len(want) == 5
    assert np.allclose(got, np.asarray(want, np.float64), rtol=0,
                       atol=1e-12, equal_nan=True)
    assert eval(last, {"nan": float("nan")}) == pytest.approx(
        got, nan_ok=True)
    assert any(v == v for v in got)


def test_sampling_dataset_bytes_equal_jax(tree, monkeypatch):
    out = {d: str(tree["root"] / f"sampled_{d}") for d in ("jax", "port")}
    args = ["-raw_dir", tree["merged"], "-sampling_period", "100000",
            "-min_event_count", "20000", "-height", "60", "-width", "76"]
    _run_jax(monkeypatch, "sampling_dataset", *args, "-target_dir",
             out["jax"])
    counts = sampling_dataset.main(args + ["-target_dir", out["port"]])
    assert counts["streams"] == 2 and counts["annotations"] == 12
    for f in ("seq0_td.dat", "seq1_td.dat", "seq0_bbox.npy",
              "seq1_bbox.npy"):
        a = Path(out["jax"], "test", f).read_bytes()
        b = Path(out["port"], "test", f).read_bytes()
        if f.endswith(".dat"):
            a, b = (x.replace(x[x.index(b"% Date"):x.index(b"% Height")],
                              b"") for x in (a, b))
        assert a == b, f
    assert counts["events"] == sum(
        PSEELoader(str(Path(out["port"], "test", f"{s}_td.dat")))
        .event_count() for s in ("seq0", "seq1"))


def test_visualization_matches_jax_tool(tree, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    out = {d: str(tree["root"] / f"viz_{d}") for d in ("jax", "port")}
    args = ["-item", "seq0", "-end", "700000", "-data_path",
            tree["paths"]["taf_dir"], "-bbox_path", tree["paths"]["labels"],
            "-dataset", "gen1_mini", "-event_type", "taf", "-flow_dir",
            tree["flow"], "-exp_name", EXP, "-log_path", tree["log"]]
    _run_jax(monkeypatch, "visualization", *args, "-result_path",
             out["jax"])
    drawn = visualization.main(args + ["-result_path", out["port"]])
    for f in ("seq0_700000_taf.png", "seq0_700000_flow.png"):
        assert os.path.exists(os.path.join(out["port"], f)), f
    j_flow = cv2.imread(os.path.join(out["jax"], "seq0_700000_flow.png"))
    np.testing.assert_array_equal(
        draw.read_png(os.path.join(out["port"], "seq0_700000_flow.png")),
        j_flow)
    np.testing.assert_array_equal(drawn["flow"], j_flow)
    j_img = cv2.imread(os.path.join(out["jax"],
                                    "seq0_700000_taf.png")).astype(int)
    p_img = draw.read_png(os.path.join(out["port"],
                                       "seq0_700000_taf.png")).astype(int)
    # outside the label rows above each box's top edge, within one level
    text = np.zeros(j_img.shape[:2], bool)
    boxes = load_bboxes(os.path.join(tree["paths"]["labels"], "test",
                                     "seq0_bbox.npy"))
    dump = np.load(os.path.join(tree["log"], EXP, "summarise.npz"))
    tops = [(int(b["x"]), int(b["y"])) for b in boxes] + [
        (int(d[1]), int(d[2])) for d in dump["dts"]]
    for x, y in tops:
        text[max(y - 12, 0):max(y - 1, 0) + 1, max(x - 1, 0):] = True
    assert (~text).sum() > 0.5 * text.size
    assert np.abs(p_img - j_img)[~text].max() <= 1
