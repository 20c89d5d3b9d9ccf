"""The port's event I/O (frlw_evd_tpu_torch/events) against the JAX
package's on the same inputs: files written byte for byte alike (the .dat
header's date line aside, which holds the clock), and every PSEELoader
call returning equal arrays and equal cursor state. Exact equality
throughout: both are numpy over the same bytes."""

from __future__ import annotations

import numpy as np
import pytest

from frlw_evd_tpu.events import box_loading as j_box
from frlw_evd_tpu.events import dat_codec as j_dat
from frlw_evd_tpu.events import npy_codec as j_npy
from frlw_evd_tpu.events.psee_loader import PSEELoader as JLoader
from frlw_evd_tpu_torch.events import box_loading as t_box
from frlw_evd_tpu_torch.events import dat_codec as t_dat
from frlw_evd_tpu_torch.events import npy_codec as t_npy
from frlw_evd_tpu_torch.events.psee_loader import PSEELoader as TLoader

H, W, N = 60, 76, 250_000


def _events(seed: int, n: int = N) -> np.ndarray:
    """n decoded events, time-sorted, with repeated timestamps."""
    rng = np.random.default_rng(seed)
    ev = np.empty(n, dtype=j_dat.DECODE_DTYPE)
    ev["ts"] = np.sort(rng.integers(0, 1_000_000, n))
    ev["x"] = rng.integers(0, W, n)
    ev["y"] = rng.integers(0, H, n)
    ev["p"] = rng.integers(0, 2, n)
    return ev


def _without_date(data: bytes) -> bytes:
    lines = data.split(b"\n")
    return b"\n".join(ln for ln in lines if not ln.startswith(b"% Date"))


@pytest.fixture(scope="module")
def dat_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("dat")
    ev = _events(0)
    paths = {"jax": str(root / "j_td.dat"), "port": str(root / "t_td.dat")}
    j_dat.write_dat_file(paths["jax"], ev, H, W)
    t_dat.write_dat_file(paths["port"], ev, H, W)
    return ev, paths


def test_dat_file_bytes_equal_jax(dat_files):
    _, paths = dat_files
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert _without_date(data["port"]) == _without_date(data["jax"])


def test_pack_unpack_and_header_equal_jax(dat_files):
    ev, paths = dat_files
    packed = t_dat.pack_events(ev["ts"], ev["x"], ev["y"], ev["p"])
    assert packed.tobytes() == j_dat.pack_events(
        ev["ts"], ev["x"], ev["y"], ev["p"]).tobytes()
    np.testing.assert_array_equal(t_dat.unpack_events(packed),
                                  j_dat.unpack_events(packed))
    with open(paths["port"], "rb") as f:
        t_head = t_dat.parse_dat_header(f)
    with open(paths["jax"], "rb") as f:
        j_head = j_dat.parse_dat_header(f)
    assert t_head == j_head and t_head[3] == (H, W)
    assert t_dat.count_events(paths["port"]) == j_dat.count_events(
        paths["jax"]) == N
    for kw in ({}, {"ev_count": 1000, "ev_start": 5000}):
        np.testing.assert_array_equal(t_dat.load_td_data(paths["port"], **kw),
                                      j_dat.load_td_data(paths["jax"], **kw))


def _boxes(seed: int, n: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = np.stack([np.sort(rng.integers(0, 10**6, n)).astype(np.float64),
                    rng.uniform(0, W, n), rng.uniform(0, H, n),
                    rng.uniform(4, 30, n), rng.uniform(4, 30, n),
                    rng.integers(0, 2, n), rng.integers(1, 9, n),
                    rng.uniform(0, 1, n)], -1)
    return arr


def test_bbox_npy_bytes_and_loading_equal_jax(tmp_path):
    arr = _boxes(1)
    t_rec, j_rec = t_box.array_to_boxes(arr), j_box.array_to_boxes(arr)
    np.save(tmp_path / "t_bbox.npy", t_rec)
    np.save(tmp_path / "j_bbox.npy", j_rec)
    assert (tmp_path / "t_bbox.npy").read_bytes() == \
        (tmp_path / "j_bbox.npy").read_bytes()
    got = t_npy.load_bboxes(str(tmp_path / "t_bbox.npy"))
    want = j_npy.load_bboxes(str(tmp_path / "j_bbox.npy"))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_box.boxes_to_array(got),
                                  j_box.boxes_to_array(want))
    # legacy names (ts, confidence) are renamed alike
    legacy = np.zeros(3, dtype=[("ts", "<i8"), ("x", "<f4"), ("y", "<f4"),
                                ("w", "<f4"), ("h", "<f4"),
                                ("class_id", "<u4"), ("track_id", "<u4"),
                                ("confidence", "<f4")])
    legacy["ts"] = [1, 2, 3]
    legacy["confidence"] = [0.5, 0.25, 1.0]
    np.save(tmp_path / "legacy.npy", legacy)
    np.testing.assert_array_equal(
        t_npy.load_bboxes(str(tmp_path / "legacy.npy")),
        j_npy.load_bboxes(str(tmp_path / "legacy.npy")))
    np.testing.assert_array_equal(t_box.reformat_boxes(legacy),
                                  j_box.reformat_boxes(legacy))
    assert t_box.BBOX_DTYPE == j_box.BBOX_DTYPE


def _state(loader):
    return (int(loader.current_time), bool(loader.done), loader._file.tell())


# each script: calls made on both loaders in turn, results and cursor state
# compared after every call
SCRIPTS = {
    "load_n_events": [("load_n_events", 1000), ("load_n_events", 1),
                      ("load_n_events", 77_777), ("load_n_events", 10**6),
                      ("load_n_events", 5)],
    "load_delta_t": [("load_delta_t", 10_000)] * 5
    + [("load_delta_t", 333_333), ("load_delta_t", 10**7),
       ("load_delta_t", 10_000)],
    "seek_time": [("seek_time", 123_456), ("load_delta_t", 10_000),
                  ("seek_time", 0), ("load_n_events", 10),
                  ("seek_time", 10**7), ("seek_time", 999_999),
                  ("load_delta_t", 50_000), ("seek_time", 500_000, 1000),
                  ("load_n_events", 3)],
    "seek_event": [("seek_event", 0), ("seek_event", 12_345),
                   ("load_delta_t", 20_000), ("seek_event", N - 1),
                   ("load_n_events", 4), ("seek_event", N + 10),
                   ("seek_event", -3), ("load_n_events", 2)],
    "introspection": [("total_time",), ("event_count",), ("get_size",),
                      ("reset",), ("load_delta_t", 1)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_psee_loader_calls_equal_jax(dat_files, script):
    _, paths = dat_files
    t_loader, j_loader = TLoader(paths["port"]), JLoader(paths["jax"])
    assert t_loader.duration_s == j_loader.duration_s
    assert t_loader.ev_type == j_loader.ev_type
    for name, *args in SCRIPTS[script]:
        got = getattr(t_loader, name)(*args)
        want = getattr(j_loader, name)(*args)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want, (name, args)
        assert _state(t_loader) == _state(j_loader), (name, args)


def test_psee_loader_reads_npy_like_jax(tmp_path):
    """The .npy branch: a structured (t, x, y, p) event file."""
    ev = _events(2, 5000)
    rec = np.zeros(len(ev), dtype=[("t", "<u4"), ("x", "<u2"), ("y", "<u2"),
                                   ("p", "<u1")])
    rec["t"] = ev["ts"]
    for k in ("x", "y", "p"):
        rec[k] = ev[k]
    path = str(tmp_path / "ev.npy")
    np.save(path, rec)
    t_loader, j_loader = TLoader(path), JLoader(path)
    assert t_loader.ev_type == j_loader.ev_type
    for call in (("load_delta_t", 40_000), ("seek_time", 600_000),
                 ("load_n_events", 100), ("load_delta_t", 10**7)):
        np.testing.assert_array_equal(getattr(t_loader, call[0])(*call[1:]),
                                      getattr(j_loader, call[0])(*call[1:]))
        assert _state(t_loader) == _state(j_loader)
    with open(path, "rb") as f:
        t_head = t_npy.parse_npy_header(f)
    with open(path, "rb") as f:
        assert t_head == j_npy.parse_npy_header(f)
