"""The port's tools against the JAX package's on the mini fixture
(tests/fixtures.py: 60x76 sensor, 64x96 input): tools/generate_taf.py's
blobs against the JAX tool's and the oracle's at tests/test_generators.py's
gate (the share of bytes off by more than one below 1e-3), and
tools/stream_infer.py's window step against the JAX functions composed as
tools/stream_infer.py:88-104 (the queue within 2e-3, the gate of
test_torch_port_streaming.py's unpacked step; the same detections per
window, each within 1e-4), then the tool end to end with a port .pth."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from frlw_evd_tpu.encode.streaming import taf_stream_step as j_step
from frlw_evd_tpu.encode.taf import leaky_transform as j_leaky
from frlw_evd_tpu.models import build_detector as j_build_detector
from frlw_evd_tpu.models.detector import eval_decode as j_eval_decode
from frlw_evd_tpu.models.postprocess import \
    finalize_detections as j_finalize
from frlw_evd_tpu.models.postprocess import postprocess_batch as j_post
from frlw_evd_tpu_torch.events import PSEELoader
from frlw_evd_tpu_torch.models import build_detector, finalize_detections
from frlw_evd_tpu_torch.tools import generate_taf, stream_infer
from frlw_evd_tpu_torch.train import adam, create_train_state, save_checkpoint
from frlw_evd_tpu_torch.weights import load_flax_variables
from test_generators import run_tool
from test_torch_port_trainer_common import NARROW, _serving_params

BLOB_GATE, STATE_TOL, DET_TOL = 1e-3, 2e-3, 1e-4


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_tools")
    return fixtures.build_mini_gen1(str(root), streams=("seq0",),
                                    splits=("test",),
                                    ann_times=(600_000, 700_000))


def _off_share(a_path, b_path):
    a = np.fromfile(a_path, np.uint8).astype(int)
    b = np.fromfile(b_path, np.uint8).astype(int)
    assert a.shape == b.shape
    return (np.abs(a - b) > 1).mean()


def test_generate_taf_matches_jax_tool_and_oracle(mini, tmp_path):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    run_tool("generate_taf", mini["events"], mini["labels"], jax_out)
    stats = generate_taf.main(["-raw_dir", mini["events"], "-label_dir",
                               mini["labels"], "-target_dir", port_out,
                               "-dataset", "gen1_mini", "-device", "cpu"])
    assert stats["blobs"] == stats["test_blobs"] == 2
    for ts in (600_000, 700_000):
        for bins in ("bins4", "bins8"):
            rel = os.path.join("test", bins, f"seq0_{ts}.npy")
            port = os.path.join(port_out, "taf", rel)
            assert _off_share(port, os.path.join(jax_out, "taf", rel)) \
                < BLOB_GATE
            assert _off_share(port, os.path.join(mini["taf_dir"], rel)) \
                < BLOB_GATE


@pytest.fixture(scope="module")
def models():
    """(flax model, variables, the port's AED on them), narrow, weights
    spread as in test_torch_port_trainer.py so boxes pass conf 0.3."""
    jm = j_build_detector(2, stem="bfm", **NARROW)
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, 64, 96, 16)), False)
    variables = {"params": _serving_params(variables["params"],
                                           np.random.default_rng(1)),
                 "batch_stats": jax.tree.map(np.array,
                                             variables["batch_stats"])}
    port = load_flax_variables(build_detector(2, stem="bfm", **NARROW),
                               variables).eval()
    return jm, variables, port


def _jax_window_step(jm, variables, sensor, input_hw, K=8):
    """tools/stream_infer.py:88-104's window_step."""
    h, w = sensor

    @jax.jit
    def step(state, xytp, n_valid):
        state = j_step(state, xytp, n_valid)
        vol = state[0][..., ::-1]
        vol = jnp.swapaxes(vol, 2, 3).reshape(h, w, 2 * K)
        vol = j_leaky(vol) / 255.0
        ys = (jnp.arange(input_hw[0]) * (h / input_hw[0])).astype(jnp.int32)
        xs = (jnp.arange(input_hw[1]) * (w / input_hw[1])).astype(jnp.int32)
        vol = jnp.take(jnp.take(vol, ys, axis=0), xs, axis=1)
        outs = jm.apply(variables, vol[None], False)
        decoded = j_eval_decode(outs, (8, 16, 32))
        return state, j_post(decoded, conf_threshold=0.3, max_detections=100)

    return step


def test_stream_infer_window_step_matches_jax(mini, models):
    jm, variables, port = models
    sensor, input_hw, _ = stream_infer.geometry("gen1_mini")
    j_window = _jax_window_step(jm, variables, sensor, input_hw)
    p_window = stream_infer.make_window_step(port, sensor, input_hw)
    j_state = jnp.full((1, *sensor, 2, 8), -6000.0, jnp.float32)
    p_state = torch.full((1, *sensor, 2, 8), -6000.0)
    loader = PSEELoader(os.path.join(mini["events"], "test", "seq0_td.dat"))
    kept = 0
    for i in range(12):
        events = loader.load_delta_t(stream_infer.BIN_US)
        xytp, n = stream_infer.window_events(events, int(loader.current_time),
                                             "gen1_mini")
        j_state, (j_dets, j_keep) = j_window(
            j_state, jnp.asarray(xytp)[None], jnp.asarray([n], jnp.int32))
        dets, keep = p_window(p_state, torch.from_numpy(xytp)[None],
                              torch.tensor([n], dtype=torch.int32))
        np.testing.assert_allclose(p_state.numpy(), np.asarray(j_state),
                                   rtol=0, atol=STATE_TOL,
                                   err_msg=f"window {i}")
        got = finalize_detections(dets, keep)[0]
        want = j_finalize(j_dets, j_keep)[0]
        assert got.shape == want.shape, f"window {i}"
        free = list(range(len(got)))
        for row in want:
            err = [np.abs(got[j] - row).max() for j in free]
            assert min(err) <= DET_TOL, (i, row, min(err))
            free.pop(int(np.argmin(err)))
        kept += int((want[:, 5] > 0).sum())
    assert kept > 0


def test_stream_infer_tool_end_to_end(mini, tmp_path, capsys):
    """The tool's main() on the CPU with a port .pth (-checkpoint): the
    windows, the detections printed and the -out npz in the JAX tool's
    layout (dts rows [t, cx, cy, w, h, cls, score], one file name a row)."""
    full = build_detector(2, stem="bfm")
    state = create_train_state(full, adam(1e-3), device="cpu")
    with torch.no_grad():
        for name, p in full.named_parameters():
            if name.startswith("head.obj_preds_") and name.endswith("bias"):
                p.fill_(2.0)
    ckpt = str(tmp_path / "best_epoch")
    save_checkpoint(ckpt, state, 0, 0.5)
    out = str(tmp_path / "dets.npz")
    res = stream_infer.main([
        "-event_file", os.path.join(mini["events"], "test", "seq0_td.dat"),
        "-dataset", "gen1_mini", "-checkpoint", ckpt, "-out", out,
        "-max_windows", "4", "-seq_nms", "-device", "cpu"])
    assert len(res["ts"]) == len(res["window_s"]) == 4
    assert res["ts"] == [10_000, 20_000, 30_000, 40_000]
    saved = np.load(out)
    rows = sum(len(d) for d in res["dets"])
    assert saved["dts"].shape == (rows, 7) and rows > 4
    np.testing.assert_array_equal(
        saved["dts"][:, 1:], np.concatenate(res["dets"]))
    assert list(saved["file_names"]) == ["seq0_td.dat"] * rows
    printed = capsys.readouterr().out
    assert "4 windows in" in printed and "box=(" in printed
