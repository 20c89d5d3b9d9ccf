"""The port's streaming encoders, histogram functions and unpacked/packed
serving pipelines against the JAX package, CPU.

JAX side: frlw_evd_tpu.encode.mxu_scatter, frlw_evd_tpu.encode.streaming and
bench.py's make_pipeline / make_pipeline_packed / run_encoder_bench steps
(the Pallas calls of the "pallas" scatter run in interpret mode). Port side:
frlw_evd_tpu_torch.encode on CPU tensors (kernels B1 and B6 through their
plain twins) and frlw_evd_tpu_torch.pipeline with device="cpu".

Tolerances, and why (each no looser than the JAX package's own test of the
same function, tests/test_streaming_red.py, tests/test_bench_pipelines.py):
  * counts exact everywhere;
  * `scatter_add_mxu` 1e-4 and `scatter_cnt_tsum_mxu` t-sums 1e-4: the same
    bf16 hi (+ lo) addends on both sides, JAX sums the columns apart in f32,
    the port (B6's twin) sums hi + lo in f64 and rounds once;
  * `segment_last_sorted` rtol 2e-4, atol 2e-2 where a cell counted (the
    JAX test's gate against the true last write): both carry bf16 hi + lo,
    JAX adds the slots its bands miss with an unrounded lo;
  * TAF steps 2e-3 over three windows carrying state (full, partial with
    out-of-crop slots, one stream empty: the freeze); the "pallas"
    precise=False histogram is kernel B1, whose exact t differs from the
    TPU's 12-bit t, so those cases snap t to multiples of 1/256 in
    [0, 0.5), where the TPU's t is exact; packed against unpacked 1e-5;
    the folded step rounds its new mean to bf16, so a mean that the two
    sides sum to f32 rounding apart may land one bf16 ulp (2^-8) apart:
    5e-3, JAX's own gate for its bf16-mean steps
    (tests/test_pallas_scatter.py:170);
  * event volume 2e-3 on the first window and 2e-2 on the incremental one
    (the JAX test's gate; both splat the same weights, index_add_ and XLA
    add in other orders); the frame exactly;
  * SAE rtol 1e-4, atol 1e-3; its sorted and max impls agree within
    rtol 1e-3, atol 1e-2 (JAX's own A/B gate);
  * pipelines: volumes atol 2e-2 (tests/test_bench_pipelines.py:100-105),
    exact where both sides compute the same f32 operations.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.encode import mxu_scatter as jmx
from frlw_evd_tpu.encode import pallas_scatter
from frlw_evd_tpu.encode import streaming as jst
from frlw_evd_tpu.encode.count_image import \
    encode_count_image as jax_count_image
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.encode import mxu_scatter, streaming
from frlw_evd_tpu_torch.encode.scatter import scatter_cnt_tsum_pallas_sorted
from frlw_evd_tpu_torch.encode.update import taf_stream_step_kernel

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

H, W = 48, 64


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas calls in interpret mode, as tests/test_pallas_scatter.py
    runs them."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_scatter.pl, "pallas_call", interp_call)


def _events(rng, B, E, t_lo=0.0, t_hi=1.0, h=H, w=W):
    ev = np.zeros((B, E, 4), np.float32)
    ev[..., 0] = rng.integers(0, w, (B, E))
    ev[..., 1] = rng.integers(0, h, (B, E))
    ev[..., 2] = np.sort(rng.uniform(t_lo, t_hi, (B, E)), axis=1)
    ev[..., 3] = rng.integers(0, 2, (B, E))
    return ev


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the histogram functions of mxu_scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batched"])
def test_scatter_add_mxu_matches_jax(rng, batched):
    """Values in [-2, 2], indices past both ends dropped."""
    size, E = 2000, 1500
    idx = rng.integers(-50, size + 50, (2, E)).astype(np.int32)
    vals = rng.uniform(-2, 2, (2, E)).astype(np.float32)
    want = np.stack([np.asarray(jmx.scatter_add_mxu(jnp.asarray(i),
                                                    jnp.asarray(v), size))
                     for i, v in zip(idx, vals)])
    got = (mxu_scatter.scatter_add_mxu(_t(idx), _t(vals), size) if batched
           else torch.stack([mxu_scatter.scatter_add_mxu(_t(i), _t(v), size)
                             for i, v in zip(idx, vals)]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("dist", ["uniform", "one_cell", "oob"])
def test_scatter_cnt_tsum_mxu_matches_jax(rng, precise, dist):
    size, E = 1000, 700
    idx = {"uniform": rng.integers(0, size, E),
           "one_cell": np.full(E, 321),
           "oob": rng.integers(-100, size + 100, E)}[dist].astype(np.int32)
    tv = rng.uniform(-1, 0, E).astype(np.float32)
    valid = rng.random(E) < 0.8
    j_cnt, j_tsum = jmx.scatter_cnt_tsum_mxu(jnp.asarray(idx), jnp.asarray(tv),
                                             jnp.asarray(valid), size, precise)
    cnt, tsum = mxu_scatter.scatter_cnt_tsum_mxu(_t(idx), _t(tv), _t(valid),
                                                 size, precise)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(j_tsum), atol=1e-4)


def test_scatter_cnt_tsum_mxu_is_b6_on_rounded_values(rng):
    """The CPU route is kernel B6's twin on JAX's bf16-rounded addends; the
    batched form equals the per-stream one."""
    size, B, E = 500, 3, 400
    idx = rng.integers(0, size, (B, E)).astype(np.int32)
    tv = rng.uniform(-1, 0, (B, E)).astype(np.float32)
    valid = rng.random((B, E)) < 0.9
    cnt, tsum = mxu_scatter.scatter_cnt_tsum_mxu(_t(idx), _t(tv), _t(valid),
                                                 size, False)
    hi = _t(tv).to(torch.bfloat16).float()
    b_cnt, b_tsum = scatter_cnt_tsum_pallas_sorted(_t(idx), hi, _t(valid),
                                                   size)
    torch.testing.assert_close(cnt, b_cnt, rtol=0, atol=0)
    torch.testing.assert_close(tsum, b_tsum, rtol=0, atol=0)
    for b in range(B):
        c1, t1 = mxu_scatter.scatter_cnt_tsum_mxu(_t(idx[b]), _t(tv[b]),
                                                  _t(valid[b]), size, False)
        torch.testing.assert_close(c1, cnt[b], rtol=0, atol=0)
        torch.testing.assert_close(t1, tsum[b], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["inband", "overflow"])
def test_segment_last_sorted_matches_jax(rng, name):
    """Last-WRITE semantics with non-monotone values, in band and on the
    striped pattern where JAX's sorted bands overflow
    (test_streaming_red.py:208-241)."""
    B, E = 2, 2048
    if name == "overflow":
        size = jmx.SORT_DELTA * 40 * jmx.LANES
        idx = (np.arange(B * E).reshape(B, E) * 7919) % size
    else:
        size = 64 * jmx.LANES
        idx = rng.integers(0, size, (B, E))
    idx = idx.astype(np.int32)
    vals = rng.uniform(-100.0, 100.0, (B, E)).astype(np.float32)
    valid = rng.random((B, E)) < 0.9
    j_cnt, j_last = jmx.segment_last_sorted(jnp.asarray(idx),
                                            jnp.asarray(vals),
                                            jnp.asarray(valid), size)
    cnt, last = mxu_scatter.segment_last_sorted(_t(idx), _t(vals), _t(valid),
                                                size)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
    has = np.asarray(j_cnt) > 0
    np.testing.assert_allclose(last.numpy()[has], np.asarray(j_last)[has],
                               rtol=2e-4, atol=2e-2)
    assert (last.numpy()[~has] == 0).all()


# ---------------------------------------------------------------------------
# the TAF steps
# ---------------------------------------------------------------------------

def _taf_windows(rng, B, E, snap):
    """Three windows: full; partial with out-of-crop slots (x past the
    sensor, p = 2, x negative); stream 1 empty (the freeze)."""
    out = []
    for i, n1 in enumerate((E, 300, 0)):
        ev = _events(rng, B, E)
        if snap:
            ev[..., 2] = np.floor(ev[..., 2] * 128.0) / 256.0
        if i == 1:
            ev[0, :20, 0] = W + 1.0
            ev[0, 20:30, 0] = -3.0
            ev[1, :20, 3] = 2.0
        out.append((ev, np.array([E, n1], np.int32)))
    return out


UNPACKED_ROUTES = {"mxu": dict(use_mxu=True), "sorted": dict(use_sorted=True),
                   "exact": dict(use_mxu=False)}


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("route", list(UNPACKED_ROUTES))
def test_unpacked_step_matches_jax(rng, route, precise):
    B, E, K = 2, 700, 8
    kw = dict(precise=precise, **UNPACKED_ROUTES[route])
    init = rng.uniform(-50, 0, (B, H, W, 2, K)).astype(np.float32)
    st, j_st = _t(init.copy()), jnp.asarray(init)
    for i, (ev, nv) in enumerate(_taf_windows(rng, B, E, snap=False)):
        prev = st.clone()
        out = streaming.taf_stream_step(st, _t(ev), _t(nv), **kw)
        assert out.data_ptr() == st.data_ptr()        # updated in place
        j_st = jst.taf_stream_step(j_st, jnp.asarray(ev), jnp.asarray(nv),
                                   **kw)
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=2e-3,
                                   err_msg=f"window {i}")
        if nv[1] == 0:
            torch.testing.assert_close(st[1], prev[1], rtol=0, atol=0)


def test_unpacked_step_takes_the_global_any_events_flag(rng):
    """any_events replaces the per-stream check (streaming.py:154-156,
    :188-191): stream 1 without local events ages, stream 0 freezes."""
    B, E, K = 2, 400, 8
    ev = _events(rng, B, E)
    nv = np.array([E, 0], np.int32)
    flags = np.array([False, True])
    init = rng.uniform(-50, 0, (B, H, W, 2, K)).astype(np.float32)
    st = streaming.taf_stream_step(_t(init.copy()), _t(ev), _t(nv),
                                   _t(flags), use_mxu=False)
    j_st = jst.taf_stream_step(jnp.asarray(init), jnp.asarray(ev),
                               jnp.asarray(nv), jnp.asarray(flags),
                               use_mxu=False)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(st[0].numpy(), init[0])
    np.testing.assert_array_equal(st[1].numpy(), init[1] - 1.0)


def test_pack_and_unpack_match_jax(rng):
    init = rng.uniform(-50, 0, (2, 5, 7, 2, 8)).astype(np.float32)
    packed = streaming.taf_pack_state(_t(init))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jst.taf_pack_state(init)))
    np.testing.assert_array_equal(
        streaming.taf_unpack_state(packed, 8).numpy(), init)


PACKED_CASES = [("pallas", False), ("pallas", True), ("sorted", False),
                ("sorted", True), ("mxu", False), ("mxu", True),
                ("xla", True)]


@pytest.mark.parametrize("scatter,precise", PACKED_CASES,
                         ids=[f"{s}-{'precise' if p else 'bf16'}"
                              for s, p in PACKED_CASES])
def test_packed_step_matches_jax(rng, interpret, scatter, precise):
    B, E, K = 2, 700, 8
    kw = dict(scatter=scatter, precise=precise)
    init = rng.uniform(-50, 0, (B, H, W, 2 * K)).astype(np.float32)
    st, j_st = _t(init.copy()), jnp.asarray(init)
    snap = scatter == "pallas" and not precise
    for i, (ev, nv) in enumerate(_taf_windows(rng, B, E, snap)):
        prev = st.clone()
        out = streaming.taf_stream_step_packed(st, _t(ev), _t(nv), **kw)
        assert out.data_ptr() == st.data_ptr()
        j_st = jst.taf_stream_step_packed(j_st, jnp.asarray(ev),
                                          jnp.asarray(nv), **kw)
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=2e-3,
                                   err_msg=f"window {i}")
        if nv[1] == 0:
            torch.testing.assert_close(st[1], prev[1], rtol=0, atol=0)


def test_packed_step_matches_unpacked_step(rng):
    """taf_stream_step_packed == pack(taf_stream_step) on the port's own
    steps, both exact (test_streaming_red.py:400-427)."""
    B, E, K = 2, 500, 8
    state = _t(np.random.default_rng(1).uniform(-50, 0, (B, H, W, 2, K))
               .astype(np.float32))
    packed = streaming.taf_pack_state(state).contiguous()
    for i, (ev, nv) in enumerate(_taf_windows(rng, B, E, snap=False)):
        streaming.taf_stream_step(state, _t(ev), _t(nv), use_mxu=False)
        streaming.taf_stream_step_packed(packed, _t(ev), _t(nv),
                                         scatter="xla")
        np.testing.assert_allclose(packed.numpy(),
                                   streaming.taf_pack_state(state).numpy(),
                                   atol=1e-5, err_msg=f"window {i}")


FOLDED_CASES = [("pallas", False), ("pallas", True), ("sorted", False),
                ("sorted", True)]


@pytest.mark.parametrize("scatter,precise", FOLDED_CASES,
                         ids=[f"{s}-{'precise' if p else 'bf16'}"
                              for s, p in FOLDED_CASES])
def test_folded_step_matches_jax(rng, interpret, scatter, precise):
    """The new mean is rounded to bf16 on both sides (streaming.py:317):
    state atol 5e-3 (module docstring)."""
    B, E, K = 2, 700, 8
    kw = dict(height=H, width=W, scatter=scatter, precise=precise)
    init = rng.uniform(-50, 0, (B, H, W * 2 * K)).astype(np.float32)
    st, j_st = _t(init.copy()), jnp.asarray(init)
    snap = scatter == "pallas" and not precise
    for i, (ev, nv) in enumerate(_taf_windows(rng, B, E, snap)):
        out = streaming.taf_stream_step_folded(st, _t(ev), _t(nv), **kw)
        assert out.data_ptr() == st.data_ptr()
        j_st = jst.taf_stream_step_folded(j_st, jnp.asarray(ev),
                                          jnp.asarray(nv), **kw)
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=5e-3,
                                   err_msg=f"window {i}")


@pytest.mark.parametrize("scatter,precise", FOLDED_CASES,
                         ids=[f"{s}-{'precise' if p else 'bf16'}"
                              for s, p in FOLDED_CASES])
def test_folded_step_is_the_kernel_steps_update(rng, scatter, precise):
    """The folded step's update is kernel B2's (taf_update_leaky): its state
    equals taf_stream_step_kernel's on the same events, bit for bit."""
    B, E, K = 2, 700, 8
    init = rng.uniform(-50, 0, (B, H, W * 2 * K)).astype(np.float32)
    st, ref = _t(init.copy()), _t(init.copy())
    kw = dict(height=H, width=W, scatter=scatter, precise=precise)
    for i, (ev, nv) in enumerate(_taf_windows(rng, B, E, snap=False)):
        streaming.taf_stream_step_folded(st, _t(ev), _t(nv), **kw)
        taf_stream_step_kernel(ref, _t(ev), _t(nv), **kw)
        torch.testing.assert_close(st, ref, rtol=0, atol=0,
                                   msg=f"window {i}")


@pytest.mark.parametrize("step,bad", [("packed", "Pallas"),
                                      ("folded", "mxu"), ("folded", "xla")])
def test_packed_steps_refuse_other_scatters(step, bad):
    """JAX's folded step sends any scatter but "pallas" to the sorted
    histogram; the port names the two it takes and refuses the rest."""
    ev, nv = torch.zeros(1, 8, 4), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="supports scatter"):
        if step == "packed":
            streaming.taf_stream_step_packed(torch.zeros(1, 4, 4, 16), ev,
                                             nv, scatter=bad)
        else:
            streaming.taf_stream_step_folded(torch.zeros(1, 4, 64), ev, nv,
                                             height=4, width=4, scatter=bad)


# ---------------------------------------------------------------------------
# event volume, frame, SAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_mxu", [True, False])
def test_event_volume_stream_matches_jax(rng, use_mxu):
    """First window (all bins), then two incremental ones carrying the
    (B, H, W, bins, 2) state; slots past n_valid and outside the window's
    bins drop."""
    B, E = 2, 800
    window, infer = 50_000, 10_000
    kw = dict(height=H, width=W, bins=5, events_window=window,
              infer_time=infer, use_mxu=use_mxu)
    state, j_state = None, None
    for i in range(3):
        now = window + i * infer
        ev = _events(rng, B, E, now - (window if i == 0 else infer) - 500,
                     now)
        nv = np.array([E, E - 123], np.int32)
        out, state = streaming.event_volume_stream(_t(ev), _t(nv), state,
                                                   now, **kw)
        j_out, j_state = jst.event_volume_stream(
            jnp.asarray(ev), jnp.asarray(nv), j_state, jnp.float32(now),
            **kw)
        assert out.shape == (B, H, W, 10)
        assert state.volume.shape == (B, H, W, 5, 2)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   atol=2e-3 if i == 0 else 2e-2,
                                   err_msg=f"window {i}")
        np.testing.assert_allclose(state.volume.numpy(),
                                   np.asarray(j_state.volume),
                                   atol=2e-3 if i == 0 else 2e-2)


def test_event_frame_stream_matches_jax(rng):
    B, E = 2, 300
    ev = _events(rng, B, E)
    nv = np.array([E, 100], np.int32)
    out, state = streaming.event_frame_stream(_t(ev), _t(nv), None,
                                              height=H, width=W)
    j_out, _ = jst.event_frame_stream(jnp.asarray(ev), jnp.asarray(nv),
                                      None, height=H, width=W)
    assert state is None
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))


@pytest.mark.parametrize("impl", ["sorted", "max"])
def test_sae_stream_matches_jax(rng, impl):
    """Default memory on the first window, then the carried one; a padded
    tail and out-of-crop slots (x negative, y past the sensor, p = 2)."""
    B, E = 2, 300
    now = 100_000.0
    kw = dict(height=H, width=W, impl=impl)
    mem, j_mem = None, None
    for i in range(2):
        ev = _events(rng, B, E, now - 10_000.0 * (i + 1), now)
        ev[0, :5, 0] = -2.0
        ev[0, 5:10, 1] = H + 3.0
        ev[1, :5, 3] = 2.0
        nv = np.array([E, E - 37], np.int32)
        out, mem = streaming.sae_stream(_t(ev), _t(nv), mem, now, **kw)
        j_out, j_mem = jst.sae_stream(jnp.asarray(ev), jnp.asarray(nv),
                                      j_mem, jnp.float32(now), **kw)
        assert out.shape == (B, H, W, 6) and mem.shape == (B, H, W, 2)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(mem.numpy(), np.asarray(j_mem),
                                   rtol=1e-4, atol=1e-3)
        now += 10_000.0


def test_sae_stream_impls_agree(rng):
    """JAX requires its two impls to agree (test_streaming_red.py:263-271);
    so does the port."""
    B, E = 2, 300
    now = 100_000.0
    ev = _events(rng, B, E, 0, now)
    nv = np.array([E - 37, E], np.int32)
    outs = {impl: streaming.sae_stream(_t(ev), _t(nv), None, now, height=H,
                                       width=W, impl=impl)
            for impl in ("sorted", "max")}
    np.testing.assert_allclose(outs["max"][0].numpy(),
                               outs["sorted"][0].numpy(), rtol=1e-3,
                               atol=1e-2)
    with pytest.raises(ValueError, match="impl"):
        streaming.sae_stream(_t(ev), _t(nv), None, now, height=H, width=W,
                             impl="last")


# ---------------------------------------------------------------------------
# the streaming encoder runner and the serving pipelines
# ---------------------------------------------------------------------------

def _jax_encoder_step(kind, h, w, sae_impl):
    """bench.py:586-610's step for `kind`."""
    if kind == "eci":
        fn = jax.jit(jax.vmap(partial(jax_count_image, height=h, width=w)))
        return lambda st, ev, nv, now: (fn(ev[..., :4], nv), None)
    if kind == "frame":
        return lambda st, ev, nv, now: jst.event_frame_stream(
            ev, nv, None, height=h, width=w)
    if kind == "ev":
        return lambda st, ev, nv, now: jst.event_volume_stream(
            ev, nv, st, jnp.float32(now), height=h, width=w, bins=5)
    return lambda st, ev, nv, now: jst.sae_stream(
        ev, nv, st, jnp.float32(now), height=h, width=w, impl=sae_impl)


ENCODER_CASES = [("eci", "sorted", 1e-3), ("frame", "sorted", 0.0),
                 ("ev", "sorted", 2e-2), ("sae", "sorted", 1e-3),
                 ("sae", "max", 1e-3)]


@pytest.mark.parametrize("kind,sae_impl,atol", ENCODER_CASES,
                         ids=["eci", "frame", "ev", "sae", "sae_max"])
def test_encoder_runner_matches_bench_steps(kind, sae_impl, atol):
    """make_encoder_step against the steps run_encoder_bench builds, on its
    synthetic windows (µs timestamps), three windows carrying state."""
    sensor, B, E = (24, 40), 2, 512
    ev0, nv = pipeline.synth_events(np.random.default_rng(0), 3, B, E,
                                    sensor)
    ev = pipeline.encoder_events(ev0)
    for i in range(3):
        np.testing.assert_array_equal(ev[i, ..., 2],
                                      (i + ev0[i, ..., 2]) * 10000.0)
    step = pipeline.make_encoder_step(kind, sensor, sae_impl=sae_impl,
                                      device="cpu")
    j_step = _jax_encoder_step(kind, *sensor, sae_impl)
    st = j_st = None
    for i in range(3):
        now = (i + 1) * 10000.0
        out, st = step(st, _t(ev[i]), _t(nv[i]), now)
        j_out, j_st = j_step(j_st, jnp.asarray(ev[i]), jnp.asarray(nv[i]),
                             now)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=1e-4 if kind == "sae" else 0,
                                   atol=atol, err_msg=f"window {i}")
    with pytest.raises(ValueError, match="kind"):
        pipeline.make_encoder_step("taf", sensor, device="cpu")


SENSOR, INPUT = (60, 76), (64, 96)      # test_bench_pipelines.py's mini GEN1
NARROW = dict(in_channels=(32, 32, 32), stem_out_channels=16, head_width=32)
PIPE_CASES = [("unpacked", "mxu", False), ("unpacked", "sorted", False),
              ("unpacked", "xla", False), ("unpacked", "mxu", True),
              ("packed", "pallas", False), ("packed", "mxu", False),
              ("packed", "sorted", False), ("packed", "xla", False)]


@pytest.mark.parametrize("layout,scatter,p64_input", PIPE_CASES,
                         ids=[f"{l}-{s}{'-p64' if p else ''}"
                              for l, s, p in PIPE_CASES])
def test_pipelines_encode_like_bench_factories(interpret, layout, scatter,
                                               p64_input):
    """make_pipeline / make_pipeline_packed's encode stage against bench.py's
    factories (fused=False), three windows carrying state: volumes 2e-2,
    state 2e-3 (t snapped where B1 runs, as in the step tests)."""
    from frlw_evd_tpu_torch.models import build_detector

    B, E = 2, 1024
    stem = "bfm_p64" if p64_input else "bfm"
    model = build_detector(2, stem=stem, **NARROW)
    if layout == "unpacked":
        j_run = bench.make_pipeline(None, None, SENSOR, INPUT, scatter,
                                    fused=False, p64_input=p64_input)
        run = pipeline.make_pipeline(model, SENSOR, INPUT, scatter,
                                     p64_input=p64_input, device="cpu",
                                     dtype=torch.float32)
    else:
        j_run = bench.make_pipeline_packed(None, None, SENSOR, INPUT,
                                           scatter=scatter)
        run = pipeline.make_pipeline_packed(model, SENSOR, INPUT, scatter,
                                            device="cpu",
                                            dtype=torch.float32)
    state = pipeline.new_stream_state(B, SENSOR, layout, device="cpu")
    j_state = jnp.array(state.numpy())     # a copy: state changes in place
    ev, nv = pipeline.synth_events(np.random.default_rng(0), 3, B, E, SENSOR)
    if scatter == "pallas":
        ev[..., 2] = np.floor(ev[..., 2] * 128.0) / 256.0
    for i in range(3):
        state, vol = run.stages["encode_transform"](state, _t(ev[i]),
                                                    _t(nv[i]))
        j_state, j_vol = j_run.stages["encode_transform"](
            j_state, jnp.asarray(ev[i]), jnp.asarray(nv[i]))
        assert vol.shape == j_vol.shape and vol.dtype == torch.bfloat16
        np.testing.assert_allclose(state.numpy(), np.asarray(j_state),
                                   atol=2e-3, err_msg=f"state, window {i}")
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
    dets, keep = run.stages["detect"](vol)
    assert dets.shape == (B, 100, 6) and torch.isfinite(dets).all()


def test_pipelines_refuse_what_bench_refuses():
    from frlw_evd_tpu_torch.models import build_detector

    model = build_detector(2, stem="bfm", **NARROW)
    with pytest.raises(ValueError, match="'mxu', 'sorted' or 'xla'"):
        pipeline.make_pipeline(model, SENSOR, INPUT, "pallas", device="cpu")
    with pytest.raises(ValueError, match="make_pipeline_packed supports"):
        pipeline.make_pipeline_packed(model, SENSOR, INPUT, "dense",
                                      device="cpu")
    with pytest.raises(ValueError, match="layout"):
        pipeline.new_stream_state(1, SENSOR, "folded", device="cpu")
