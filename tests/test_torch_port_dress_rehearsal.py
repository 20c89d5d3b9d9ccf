"""The port's dress rehearsal, learnability and int8 eval step against the
JAX package's, on the CPU, on the mini tree (tests/fixtures.py geometry:
60x76 sensor, 64x96 input):
  * tools/dress_rehearsal.py's encode_stream_taf (the queue of
    encode/taf.py on the CPU) equals the JAX tool's numpy-oracle blobs
    exactly;
  * the whole tool, with one JAX-initialised narrow AED carried across by
    weights.py (BatchNorm affines spread and the obj biases raised so
    boxes pass conf 0.3), gives the JAX tool's windows and streams, per
    window the same number of detections, each within 2e-4 of JAX's (the
    gates of the port's postprocess tests: keep masks equal, boxes within
    2e-4), and its mAP to 1e-6; in -blob_dir mode on the tree's oracle
    blobs it gives the same windows and the same mAP;
  * make_eval_step(quant=...) against JAX's with the same scales and
    table carried across, stage by stage (see its test);
  * learnability at -streams 2 -epochs 1 -batch 2 -int8_eval prints its
    JSON keys;
  * the new entry points raise without a card unless given the CPU.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as j_build_detector
from frlw_evd_tpu.models import quantize as jq
from frlw_evd_tpu.train.trainer import \
    create_train_state as j_create_train_state
from frlw_evd_tpu.train.trainer import make_eval_step as j_make_eval_step
from frlw_evd_tpu_torch.data import synthetic
from frlw_evd_tpu_torch.events.npy_codec import load_bboxes
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models import quantize as q
from frlw_evd_tpu_torch.tools import (dress_rehearsal, generate_opticalflow,
                                      learnability)
from frlw_evd_tpu_torch.train import adam, create_train_state, make_eval_step
from frlw_evd_tpu_torch.weights import load_flax_variables

ROOT = Path(__file__).resolve().parent.parent
SENSOR, INPUT = (60, 76), (64, 96)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
WIDE = dict(in_channels=(64, 64, 64), stem_out_channels=64, head_width=64)
BOX_TOL, MAP_TOL = 2e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process while the file runs (the suite's
    other workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdr():
    """The JAX root tool tools/dress_rehearsal.py."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import dress_rehearsal as jdr
    finally:
        sys.path.pop(0)
    return jdr


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.build_mini_gen1(str(tmp_path_factory.mktemp("dr")),
                                     splits=("test",), blobs=("taf",))


def test_encode_stream_taf_equals_jax(jdr, tree):
    n = 0
    for stream in ("seq0", "seq1"):
        ev = os.path.join(tree["events"], "test", f"{stream}_td.dat")
        ann = np.unique(load_bboxes(os.path.join(
            tree["labels"], "test", f"{stream}_bbox.npy"))["t"])
        want = list(jdr.encode_stream_taf(ev, ann, SENSOR, INPUT, 10_000, 8))
        got = list(dress_rehearsal.encode_stream_taf(ev, ann, SENSOR, INPUT,
                                                     10_000, 8, "cpu"))
        assert [t for t, _ in got] == [t for t, _ in want]
        for (t, g), (_, w) in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (16, *INPUT)
            np.testing.assert_array_equal(g, np.asarray(w, np.uint8),
                                          err_msg=f"{stream} {t}")
            n += 1
    assert n == 6


def _spread(params, rng, obj_bias=2.0, cls_bias=0.0):
    """BatchNorm scales U(1, 1.5) and biases N(0, 0.3), obj biases raised,
    the regression biases at boxes of 8 px: boxes pass conf 0.3."""
    flat = {}
    for path, a in flatten_dict(jax.tree.map(np.array, params)).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 1.5, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.3, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = obj_bias
        elif path[-2].startswith("cls_preds_") and path[-1] == "bias":
            a[:] = cls_bias
        elif path[-2].startswith("reg_preds_") and path[-1] == "bias":
            a[:] = [0.0, 0.0, np.log(8.0), np.log(8.0)]
        flat[path] = a
    return unflatten_dict(flat)


def _carried(widths, seed=0):
    """(flax model, spread variables, the port's AED on them, f32 eval)."""
    jm = j_build_detector(2, stem="bfm", **widths)
    v = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(seed), jnp.zeros((1, *INPUT, 16)), False)
    v = {"params": _spread(v["params"], np.random.default_rng(seed)),
         "batch_stats": jax.tree.map(np.array, v["batch_stats"])}
    port = load_flax_variables(build_detector(2, stem="bfm", **widths),
                               v).float().eval()
    return jm, v, port


class _JaxModel:
    """build_detector's stand-in for the JAX tool: init returns the carried
    variables, apply is the flax model's."""

    def __init__(self, jm, variables):
        self.jm, self.variables = jm, variables

    def init(self, *args):
        return jax.tree.map(jnp.asarray, self.variables)

    def apply(self, *args, **kw):
        return self.jm.apply(*args, **kw)


def _run_jax_tool(jdr, monkeypatch, capsys, jm, variables, argv):
    """JAX's main() on argv with the carried model; returns (its JSON,
    per window its finalized detections)."""
    import frlw_evd_tpu.evaluate.evaluator as jev
    import frlw_evd_tpu.models as jmodels

    dets = []

    class Recording(jev.Evaluator):
        def add_result(self, outputs, *args):
            dets.append(np.asarray(outputs[0]))
            return super().add_result(outputs, *args)

    monkeypatch.setattr(jmodels, "build_detector",
                        lambda *a, **k: _JaxModel(jm, variables))
    monkeypatch.setattr(jev, "Evaluator", Recording)
    monkeypatch.setattr(sys, "argv", ["dress_rehearsal.py", *argv])
    capsys.readouterr()
    jdr.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    return json.loads(line), dets


def test_tool_matches_jax_with_carried_weights(jdr, tree, monkeypatch,
                                               capsys):
    jm, variables, port = _carried(NARROW)
    common = ["-label_dir", tree["labels"], "-dataset", "gen1", "-split",
              "test", "-sensor_hw", "60,76", "-input_hw", "64,96",
              "-eval_filter", "none"]
    raw = ["-raw_dir", tree["events"]] + common
    want, j_dets = _run_jax_tool(jdr, monkeypatch, capsys, jm, variables,
                                 raw)
    got = dress_rehearsal.dress_rehearsal(
        dress_rehearsal.parse_args(raw + ["-device", "cpu"]), model=port)
    out = capsys.readouterr().out
    assert json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1]).keys() == want.keys()
    assert (got["windows"], got["streams"]) == (want["windows"],
                                                want["streams"]) == (6, 2)
    assert sum(len(d) for d in j_dets) > 6     # boxes were kept
    for i, (g, w) in enumerate(zip(got["dets"], j_dets)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=BOX_TOL,
                                   err_msg=f"window {i}")
    assert abs(got["mAP"] - want["value"]) <= 5e-5    # JAX rounds to 1e-4
    j_map = jdr_map(jdr, tree, monkeypatch, capsys, jm, variables, raw)
    assert abs(got["mAP"] - j_map) <= MAP_TOL

    blob = dress_rehearsal.dress_rehearsal(dress_rehearsal.parse_args(
        ["-blob_dir", tree["taf_dir"]] + common + ["-device", "cpu"]),
        model=port)
    assert (blob["windows"], blob["streams"]) == (6, 2)
    assert blob["mAP"] == got["mAP"]


def jdr_map(jdr, tree, monkeypatch, capsys, jm, variables, argv):
    """The JAX tool's unrounded mAP: its evaluator's stats[0]."""
    import frlw_evd_tpu.evaluate.evaluator as jev

    seen = []
    evaluate = jev.Evaluator.evaluate

    def record(self):
        stats = evaluate(self)
        seen.append(float(stats[0]))
        return stats

    monkeypatch.setattr(jev.Evaluator, "evaluate", record)
    _run_jax_tool(jdr, monkeypatch, capsys, jm, variables, argv)
    return seen[-1]


def test_int8_eval_step_matches_jax(tree):
    """make_eval_step(quant=...) against JAX's, on the 64-wide AED (34
    sites) and three of the tree's TAF windows, calibrated on two others,
    JAX's scales and table in both. Every site runs the twin; the step's
    rows before NMS (eval_step.decoded) within relative L2 0.02 of JAX's
    int8 rows (test_torch_port_quantize.py's gate on int8 maps; about 1e-3
    here, from activation codes that round apart where the two frameworks'
    f32 activations differ in the last place); the step's (dets, keep)
    exactly postprocess_batch of its own rows; and postprocess_batch of
    JAX's rows gives JAX's step: keep masks equal, dets within the int8
    gates (rtol 1e-4, atol 1e-3). The two steps' keep masks themselves are
    not held equal: on seeded weights about 150 boxes a window pass conf
    0.3 with scores 1e-3 apart, and NMS orders them by those scores."""
    from frlw_evd_tpu.models.detector import eval_decode as j_eval_decode
    from frlw_evd_tpu_torch.models import postprocess_batch

    jm, variables, port = _carried(WIDE, seed=1)
    vols = []
    for stream in ("seq0", "seq1"):
        for t in (600_000, 700_000, 800_000):
            halves = [np.fromfile(os.path.join(tree["taf_dir"], "test", b,
                                               f"{stream}_{t}.npy"),
                                  np.uint8).reshape(8, *INPUT)
                      for b in ("bins4", "bins8")]
            vols.append(np.concatenate(halves).transpose(1, 2, 0))
    vols = np.stack(vols).astype(np.float32) / 255.0
    calib, imgs = [vols[:2], vols[2:3]], vols[3:]
    jv = jax.tree.map(jnp.asarray, variables)
    scales = jq.calibrate_int8(jm, jv, [jnp.asarray(c) for c in calib])
    table = jq.build_weight_table(jv["params"], scales)
    j_state = j_create_train_state(jm, jax.random.key(0),
                                   jnp.zeros((1, *INPUT, 16)),
                                   optax.adam(1e-3))
    j_state = j_state.replace(params=jv["params"],
                              batch_stats=jv["batch_stats"])
    j_dets, j_keep = (np.asarray(a) for a in j_make_eval_step(
        (8, 16, 32), max_detections=50, quant=(scales, table))(
            j_state, jnp.asarray(imgs)))

    @jax.jit
    def j_rows(v, x):
        with jq.int8_ctx(scales, table):
            outs = jm.apply(v, x, False)
        return j_eval_decode([o.astype(jnp.float32) for o in outs],
                             (8, 16, 32))

    j_dec = np.asarray(j_rows(jv, jnp.asarray(imgs)))

    ptable = {k: (torch.from_numpy(np.asarray(kq).transpose(3, 2, 0, 1)
                                   .copy()), torch.from_numpy(np.array(sw)))
              for k, (kq, sw) in table.items()}
    state = create_train_state(port, adam(1e-3), device="cpu")
    step = make_eval_step((8, 16, 32), max_detections=50,
                          quant=(scales, ptable), device="cpu")
    calls = []
    hook = q.int8_conv2d_plain

    def count(*a, **k):
        calls.append(1)
        return hook(*a, **k)

    q.int8_conv2d_plain = count
    try:
        dets, keep = step(state, torch.from_numpy(imgs))
        n_calls = len(calls)
        rows = step.decoded(state, torch.from_numpy(imgs))
    finally:
        q.int8_conv2d_plain = hook
    assert n_calls == len(scales) == len(q.eligible_sites(port)) > 30
    rel = np.linalg.norm(rows.numpy() - j_dec) / np.linalg.norm(j_dec)
    assert rel <= 0.02, rel
    own = postprocess_batch(rows, max_detections=50)
    assert torch.equal(own[0], dets) and torch.equal(own[1], keep)
    p_dets, p_keep = postprocess_batch(torch.from_numpy(j_dec.copy()),
                                       max_detections=50)
    assert j_keep.sum() > 0
    np.testing.assert_array_equal(p_keep.numpy(), j_keep)
    np.testing.assert_allclose(p_dets.numpy()[j_keep], j_dets[j_keep],
                               rtol=1e-4, atol=1e-3)
    plain = make_eval_step((8, 16, 32), max_detections=50,
                           device="cpu").decoded(state,
                                                 torch.from_numpy(imgs))
    assert not torch.equal(plain, rows)


def test_learnability_prints_its_keys(tmp_path, capsys):
    result = learnability.main(["-streams", "2", "-epochs", "1", "-batch",
                                "2", "-int8_eval", "-device", "cpu",
                                "-out", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert set(line) == {"metric", "value", "map", "best_epoch", "streams",
                         "epochs", "map_f32_final", "ap50_f32_final",
                         "map_int8", "ap50_int8"}
    assert line["streams"] == 2 and line["epochs"] == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", ["dress_rehearsal", "learnability",
                                   "generate_opticalflow"])
def test_entries_raise_without_a_card(entry, tree, tmp_path):
    argv = {"dress_rehearsal": ["-raw_dir", tree["events"], "-label_dir",
                                tree["labels"]],
            "learnability": ["-out", str(tmp_path)],
            "generate_opticalflow": ["-raw_dir", tree["events"],
                                     "-label_dir", tree["labels"],
                                     "-out_dir", str(tmp_path)]}[entry]
    mod = {"dress_rehearsal": dress_rehearsal, "learnability": learnability,
           "generate_opticalflow": generate_opticalflow}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)


def test_load_model_takes_a_port_checkpoint_and_its_ema(tmp_path):
    """A port checkpoint (train.save_checkpoint's dict) loads its EMA
    parameters when it holds them, its masters otherwise."""
    src = build_detector(2, stem="bfm",
                         generator=torch.Generator().manual_seed(3))
    sd = src.state_dict()
    ema = {k: p.detach() * 0.5 for k, p in src.named_parameters()}
    for name, held in (("ema", ema), ("plain", None)):
        path = str(tmp_path / name)
        torch.save({"model": sd, "ema": held, "optimizer": {}, "step": 1,
                    "epoch": 0, "max_score": 0.0}, path)
        model = dress_rehearsal.load_model(2, 8, path, device="cpu")
        assert not model.training
        for k, p in model.named_parameters():
            want = held[k] if held is not None else sd[k]
            assert torch.equal(p, want), (name, k)
