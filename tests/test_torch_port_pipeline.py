"""The port's GEN1 serving slice end to end against the JAX pipeline, CPU.

JAX side: bench.make_pipeline_kernel(...).stages["encode_transform"], then
model.apply → eval_decode → postprocess_batch(max_detections=100), as
bench._detect_body runs it. Port side: frlw_evd_tpu_torch.pipeline on
device="cpu" (the kernels' plain twins), same events and weights, three
windows carrying state, both in f32 (the JAX volume is cast to f32 before
apply so that its weight-norm stem convs run in f32 too).

The event times are snapped to multiples of 1/256 in [0, 0.5): there the
JAX path's 12-bit quantised, bf16-rounded t equals the port's exact t, so
both states, volumes and detector inputs agree bit for bit and the keep
masks must be identical. (With unsnapped t, the volumes agree to the 2e-2
of tests/test_torch_port_encode.py.) The test asserts that some boxes are
kept and some are suppressed by NMS.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from frlw_evd_tpu.models import build_detector as jax_build
from frlw_evd_tpu.models.detector import eval_decode as jax_eval_decode
from frlw_evd_tpu.models.postprocess import \
    postprocess_batch as jax_postprocess
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.weights import load_flax_variables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

SENSOR, INPUT = (60, 72), (64, 96)       # mini GEN1 (test_bench_pipelines)
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
B, E = 2, 1024
OBJ_BIAS = 2.0


def _serving_variables(widths=NARROW):
    """JAX init with the BatchNorm affines spread (scale U(1, 2), bias
    N(0, 0.5): at the identity init the head outputs are nearly constant,
    so near-tied scores would make the top-k order arbitrary) and the obj
    biases raised so that boxes pass conf 0.3."""
    jmodel = jax_build(2, family="aed", stem="bfm", **widths)
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, *INPUT, 16), jnp.float32), False)
    rng = np.random.default_rng(0)
    flat = {}
    for path, a in flatten_dict(variables["params"]).items():
        a = np.array(a, np.float32)
        if path[-2:-1] == ("bn",):
            a = (rng.uniform(1.0, 2.0, a.shape) if path[-1] == "scale"
                 else rng.normal(0.0, 0.5, a.shape)).astype(np.float32)
        elif path[-2].startswith("obj_preds_") and path[-1] == "bias":
            a[:] = OBJ_BIAS
        flat[path] = a
    stats = jax.tree.map(lambda a: np.array(a, np.float32),
                         variables["batch_stats"])
    return jmodel, {"params": unflatten_dict(flat), "batch_stats": stats}


def _windows():
    ev_u, nv_u = pipeline.synth_events(np.random.default_rng(0), 2, B, E,
                                       SENSOR)
    ev_s, nv_s = pipeline.synth_events_skewed(np.random.default_rng(1), 1, B,
                                              E, SENSOR)
    out = [(ev_u[0], nv_u[0]), (ev_s[0], nv_s[0]), (ev_u[1], nv_u[1])]
    for ev, _ in out:
        ev[..., 2] = np.floor(ev[..., 2] * 128.0) / 256.0
    return out


def test_serving_slice_matches_jax_pipeline():
    jmodel, variables = _serving_variables()
    j_enc = bench.make_pipeline_kernel(jmodel, variables, SENSOR, INPUT,
                                       scatter="pallas"
                                       ).stages["encode_transform"]
    j_apply = jax.jit(lambda v, x: jmodel.apply(v, x, False))

    tmodel = load_flax_variables(build_detector(2, stem="bfm", **NARROW),
                                 variables)
    run = pipeline.make_pipeline_kernel(tmodel, SENSOR, INPUT, device="cpu",
                                        dtype=torch.float32)
    enc, detect = run.stages["encode_transform"], run.stages["detect"]

    state = pipeline.new_state(B, SENSOR, device="cpu")
    j_state = jnp.full((B, SENSOR[0], SENSOR[1] * 16), -6000.0, jnp.float32)
    n_kept = n_suppressed = 0
    for i, (ev, nv) in enumerate(_windows()):
        state, vol = enc(state, torch.from_numpy(ev), torch.from_numpy(nv))
        j_state, j_vol = j_enc(j_state, jnp.asarray(ev), jnp.asarray(nv))
        assert vol.shape == (B, *INPUT, 16) and vol.dtype == torch.bfloat16
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        np.testing.assert_array_equal(state.numpy(), np.asarray(j_state),
                                      err_msg=f"state, window {i}")

        dets, keep = detect(vol)
        j_outs = [o.astype(jnp.float32)
                  for o in j_apply(variables, j_vol.astype(jnp.float32))]
        j_dets, j_keep = jax_postprocess(
            jax_eval_decode(j_outs, pipeline.STRIDES), max_detections=100)
        j_keep = np.asarray(j_keep)
        np.testing.assert_array_equal(keep.numpy(), j_keep,
                                      err_msg=f"keep, window {i}")
        np.testing.assert_allclose(dets.numpy()[j_keep],
                                   np.asarray(j_dets)[j_keep], rtol=1e-4,
                                   atol=1e-3, err_msg=f"dets, window {i}")
        valid = np.asarray(j_dets)[..., 5] > 0   # top-k rows past conf 0.3
        n_kept += int(j_keep.sum())
        n_suppressed += int((valid & ~j_keep).sum())
    assert n_kept > 0 and n_suppressed > 0, (n_kept, n_suppressed)


WIDE = dict(in_channels=(64, 64, 64), stem_out_channels=64, head_width=64)


def test_int8_serving_slice_matches_jax_pipeline():
    """The int8 path (bench.py --dtype int8) on the CPU, with the wiring
    of tests/test_bench_pipelines.py:19-64: a 64-wide AED so that the
    sites engage; JAX calibrates on two encoded windows as bench.main
    does and builds the table from the f32 params; the port's
    calibrate_pipeline on the same windows gives the same sites and
    scales (rtol 1e-5: max|x| of f32 activations that agree to f32
    rounding, through up to 30 convs whose sums run in another order;
    1.06e-6 seen). With JAX's scales and tables in both, the port's
    make_pipeline_kernel(quant=...) detect keeps the same boxes as JAX's
    int8 detect body (bench._detect_body: int8_ctx, apply, f32 decode,
    NMS) and as many as JAX's make_pipeline_kernel(quant=...) detect
    stage counts, f32 on both sides. Every site ran the int8 conv; empty
    scales leave detect bit for bit."""
    from frlw_evd_tpu.models import quantize as jq
    from frlw_evd_tpu_torch.models import quantize as q

    jmodel, variables = _serving_variables(WIDE)
    windows = _windows()
    j_enc = bench.make_pipeline_kernel(jmodel, variables, SENSOR, INPUT,
                                       scatter="pallas"
                                       ).stages["encode_transform"]
    j_state = jnp.full((B, SENSOR[0], SENSOR[1] * 16), -6000.0, jnp.float32)
    j_vols = []
    for ev, nv in windows[:2]:
        j_state, j_vol = j_enc(j_state, jnp.asarray(ev), jnp.asarray(nv))
        j_vols.append(j_vol.astype(jnp.float32))
    scales = jq.calibrate_int8(jmodel, variables, j_vols)
    table = jq.build_weight_table(variables["params"], scales)

    tmodel = load_flax_variables(build_detector(2, stem="bfm", **WIDE),
                                 variables)
    f32_state = {k: v.clone() for k, v in tmodel.state_dict().items()}
    base = pipeline.make_pipeline_kernel(tmodel, SENSOR, INPUT, device="cpu",
                                         dtype=torch.float32)
    state = pipeline.new_state(B, SENSOR, device="cpu")
    pscales, ptable = pipeline.calibrate_pipeline(
        base, tmodel, f32_state, state,
        [(torch.from_numpy(ev), torch.from_numpy(nv))
         for ev, nv in windows[:2]])
    assert set(pscales) == set(scales) == set(q.eligible_sites(tmodel))
    for key, sx in scales.items():
        np.testing.assert_allclose(pscales[key], sx, rtol=1e-5, err_msg=key)
        kq, sw = table[key]
        assert torch.equal(ptable[key][0], torch.from_numpy(
            np.asarray(kq).transpose(3, 2, 0, 1).copy())), key
        assert torch.equal(ptable[key][1], torch.from_numpy(np.array(sw)))

    jax_table = {k: (torch.from_numpy(np.asarray(kq).transpose(3, 2, 0, 1)
                                      .copy()), torch.from_numpy(np.array(sw)))
                 for k, (kq, sw) in table.items()}
    quant = pipeline.make_pipeline_kernel(tmodel, SENSOR, INPUT, device="cpu",
                                          dtype=torch.float32,
                                          quant=(scales, jax_table))
    noop = pipeline.make_pipeline_kernel(tmodel, SENSOR, INPUT, device="cpu",
                                         dtype=torch.float32, quant=({}, {}))
    j_quant = bench.make_pipeline_kernel(jmodel, variables, SENSOR, INPUT,
                                         scatter="pallas",
                                         quant=(scales, table))

    @jax.jit
    def j_detect_body(vol):
        with jq.int8_ctx(scales, table):
            outs = jmodel.apply(variables, vol, False)
        return jax_postprocess(
            jax_eval_decode([o.astype(jnp.float32) for o in outs],
                            pipeline.STRIDES), max_detections=100)

    j_vol = j_vols[-1]
    vol = torch.from_numpy(np.array(j_vol))
    before = q.int8_conv2d.launches
    dets, keep = quant.stages["detect"](vol)
    assert q.int8_conv2d.launches == before    # CPU: the twin, no launch
    j_dets, j_keep = (np.asarray(a) for a in j_detect_body(j_vol))
    assert j_keep.sum() > 0
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    np.testing.assert_allclose(dets.numpy()[j_keep], j_dets[j_keep],
                               rtol=1e-4, atol=1e-3)
    assert int(keep.sum()) == int(j_quant.stages["detect"](j_vol))
    b_dets, b_keep = base.stages["detect"](vol)
    n_dets, n_keep = noop.stages["detect"](vol)
    assert torch.equal(n_dets, b_dets) and torch.equal(n_keep, b_keep)
    assert not torch.equal(dets, b_dets)


def test_resize_indices_match_jax():
    """The port's nearest-resize index vectors equal the JAX pipeline's
    float32 arange * (h / H) truncation (bench.py:204-205)."""
    for sensor, inp in (((240, 304), (256, 320)), (SENSOR, INPUT)):
        ys, xs = pipeline.nearest_resize_indices(sensor, inp)
        j_ys = (jnp.arange(inp[0]) * (sensor[0] / inp[0])).astype(jnp.int32)
        j_xs = (jnp.arange(inp[1]) * (sensor[1] / inp[1])).astype(jnp.int32)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(j_ys))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(j_xs))


def test_synthetic_events_are_bench_copies():
    for port_fn, jax_fn in ((pipeline.synth_events, bench.synth_events),
                            (pipeline.synth_events_skewed,
                             bench.synth_events_skewed)):
        ev, nv = port_fn(np.random.default_rng(5), 2, 3, 512, SENSOR)
        j_ev, j_nv = jax_fn(np.random.default_rng(5), 2, 3, 512, SENSOR)
        np.testing.assert_array_equal(ev, np.asarray(j_ev))
        np.testing.assert_array_equal(nv, np.asarray(j_nv))
