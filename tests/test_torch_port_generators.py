"""The port's EV, ECI and SAE blob generators (frlw_evd_tpu_torch/tools/
generate_eventvolume.py, generate_eventcountimage.py,
generate_surfaceofactiveevents.py) against the JAX package's tools and the
oracle on the CPU.

The mini fixture (tests/fixtures.py: one 1 s test stream at 60x76, blobs
at 64x96, annotations at 600 and 700 ms). Each JAX tool runs as
tests/test_generators.py runs it: a subprocess under JAX_PLATFORMS=cpu
with the mini geometry patched into its "gen1" entry; the port's tool
runs its main() with -dataset gen1_mini -device cpu. The oracle's blobs
are chip_smoke.oracle_generator_blobs' (encode/oracle.py in numpy over the
whole recording). Gate: the share of bytes that differ by more than one,
at most 1e-3 in every blob (the generate_taf gate of
test_torch_port_tools.py), against the JAX tool's and against the
oracle's.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import fixtures
from frlw_evd_tpu_torch.tools import (generate_common,
                                      generate_eventcountimage,
                                      generate_eventvolume,
                                      generate_surfaceofactiveevents)
from test_generators import run_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import generator_off_share, oracle_generator_blobs  # noqa

BLOB_GATE = 1e-3
TOOLS = {"eventvolume": generate_eventvolume,
         "eventcountimage": generate_eventcountimage,
         "surfaceofactiveevents": generate_surfaceofactiveevents}
# encodes a tool makes per annotation time (three windows; SAE one for
# its three λ); each tool writes three blobs per annotation time
ENCODES = {"eventvolume": 3, "eventcountimage": 3,
           "surfaceofactiveevents": 1}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_generators")
    return fixtures.build_mini_gen1(str(root), streams=("seq0",),
                                    splits=("test",),
                                    ann_times=(600_000, 700_000))


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_generator_matches_jax_tool_and_oracle(mini, tmp_path, tool,
                                               capsys):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    run_tool(f"generate_{tool}", mini["events"], mini["labels"], jax_out)
    stats = TOOLS[tool].main(["-raw_dir", mini["events"], "-label_dir",
                              mini["labels"], "-target_dir", port_out,
                              "-dataset", "gen1_mini", "-device", "cpu"])
    assert stats["blobs"] == stats["test_blobs"] == 2 * ENCODES[tool]
    assert "Average Representation time: " in capsys.readouterr().out
    oracle = oracle_generator_blobs(
        tool, os.path.join(mini["events"], "test", "seq0_td.dat"),
        os.path.join(mini["labels"], "test", "seq0_bbox.npy"),
        fixtures.SENSOR_HW, fixtures.INPUT_HW)
    assert len(oracle) == 2 * 3
    for rel, blob in oracle.items():
        assert blob.shape == (2 * (5 if tool == "eventvolume" else 1),
                              *fixtures.INPUT_HW), rel
    worst, n = generator_off_share(port_out, oracle)
    assert n == len(oracle) and worst <= BLOB_GATE
    worst, n = generator_off_share(port_out, jax_out)
    assert n == len(oracle) and worst <= BLOB_GATE


def test_encode_timer_reports_as_jax(capsys):
    """EncodeTimer (tools/generate_common.py:56-72): the same report."""
    spec = importlib.util.spec_from_file_location(
        "jax_generate_common", os.path.join(REPO, "tools",
                                            "generate_common.py"))
    j_common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_common)

    for timer_cls in (generate_common.EncodeTimer, j_common.EncodeTimer):
        timer = timer_cls([250000, 500000])
        timer.add(250000, 0.5)
        timer.add(250000, 0.25)
        timer.report()
    port, jax_text = capsys.readouterr().out.split(
        "Average Representation time: \n")[1:]
    assert "Average Representation time: \n" + port == \
        "Average Representation time: \n" + jax_text
    assert port == "250000 0.375\n"


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_generator_asks_for_the_card(mini, tmp_path, monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(TOOLS[tool], f"generate_{tool}")(
            mini["events"], mini["labels"], str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


def test_gen4_geometry_scales_the_coordinates(mini, tmp_path, monkeypatch):
    """Below the sensor's size (gen4) the coordinates are scaled before
    encoding at the blob's size, as the JAX tools do: an EV blob on a
    halved geometry equals the oracle's volume of the scaled events."""
    from frlw_evd_tpu_torch.encode import oracle
    from frlw_evd_tpu_torch.events.dat_codec import load_td_data

    monkeypatch.setitem(generate_common.GEOMETRY, "half",
                        dict(shape=fixtures.SENSOR_HW, target_shape=(30, 38)))
    generate_eventvolume.generate_eventvolume(
        mini["events"], mini["labels"], str(tmp_path), "half", "cpu")
    raw = load_td_data(os.path.join(mini["events"], "test", "seq0_td.dat"))
    ts = 600_000
    keep = (raw["ts"] > ts - 250_000) & (raw["ts"] < ts)
    ev = np.stack([raw["x"][keep] * (38 / 76), raw["y"][keep] * (30 / 60),
                   (raw["ts"][keep] - (ts - 250_000)) / 250_000,
                   raw["p"][keep]], -1).astype(np.float32)
    want = oracle.to_uint8(oracle.event_volume(ev, (30, 38), 5))
    got = np.fromfile(tmp_path / "EventVolume250000" / "test" /
                      f"seq0_{ts}.npy", np.uint8).reshape(want.shape)
    assert (np.abs(got.astype(int) - want) > 1).mean() <= BLOB_GATE
