"""The port's kernel build rebuilds a library whose source, or a header the
source includes from csrc/, is newer than it (kernels/_build.py). Runs
without nvcc: only the staleness rule is exercised, on temporary files."""

from __future__ import annotations

import os

import pytest

from frlw_evd_tpu_torch.kernels import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """csrc/k.cu including "common.cuh", which includes "inner.cuh", and a
    built build/libk.so newer than all three."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "common.cuh"\nint k;\n')
    (csrc / "common.cuh").write_text('#pragma once\n #  include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (build / "libk.so").write_bytes(b"")
    for name in ("k.cu", "common.cuh", "inner.cuh"):
        os.utime(csrc / name, (1000, 1000))
    os.utime(build / "libk.so", (2000, 2000))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    return csrc, build


def test_fresh_library_is_not_stale(tree):
    assert not _build._stale("k")


@pytest.mark.parametrize("touched", ["k.cu", "common.cuh", "inner.cuh"])
def test_newer_source_or_header_makes_it_stale(tree, touched):
    csrc, _ = tree
    os.utime(csrc / touched, (3000, 3000))
    assert _build._stale("k")


def test_missing_library_is_stale(tree):
    _, build = tree
    (build / "libk.so").unlink()
    assert _build._stale("k")


def test_every_source_is_listed():
    """SOURCES names every csrc/*.cu, so build() compiles them all."""
    assert sorted(_build.SOURCES) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", _build.SOURCES)
def test_every_listed_source_exists(name):
    """Each name in SOURCES has its csrc/<name>.cu, with the C entries its
    wrappers load."""
    assert (_build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("name,entries", [
    ("scatter_hist", ["scatter_cnt_tsum"]),
    ("scatter_sorted", ["scatter_cnt_tsum_sorted_runs"]),
    ("scatter_dense", ["scatter_cnt_tsum_dense"]),
    ("taf_update", ["taf_update_leaky", "taf_update_leaky_raw",
                    "taf_update_leaky_v2"]),
    ("bfm_chain", ["bfm_chain_apply", "bfm_chain_apply_folded"])])
def test_sources_define_the_entries_their_wrappers_call(name, entries):
    text = (_build.CSRC / f"{name}.cu").read_text()
    for entry in entries:
        assert f'extern "C" int {entry}(' in text, f"{name}.cu: {entry}"
