"""The port's offline encoders, shared helpers and numpy oracle against the
JAX package and its oracle, CPU.

JAX side: frlw_evd_tpu.encode (common, count_image, event_volume, sae, taf,
oracle). Port side: frlw_evd_tpu_torch.encode on CPU tensors.

Tolerances, and why (the gates of tests/test_encoders.py for the same
functions):
  * helpers, index maps, resizes and the oracle copy: exact;
  * `leaky_transform` rtol 1e-6 (log1p of two libraries, an ulp or two),
    atol 1e-4 where the output nears 0 (x255, so 4e-7 of the [0, 1] value);
  * count image 1e-3 (sums of 0.05 in f32, another order of adds);
  * event volume 2e-3 (two weights a slot summed in f32);
  * SAE rtol 1e-4, atol 1e-3 (f32 exp of the same f32 argument);
  * TAF queue 2e-3 (f32 means of the same sums).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.encode import common as jcommon
from frlw_evd_tpu.encode import oracle as joracle
from frlw_evd_tpu.encode import taf as jtaf
from frlw_evd_tpu.encode.count_image import (encode_count_image as
                                             jax_count_image,
                                             encode_count_image_batch as
                                             jax_count_image_batch)
from frlw_evd_tpu.encode.event_volume import (encode_event_volume as
                                              jax_event_volume,
                                              encode_event_volume_batch as
                                              jax_event_volume_batch)
from frlw_evd_tpu.encode.sae import encode_sae as jax_sae
from frlw_evd_tpu.encode.sae import encode_sae_batch as jax_sae_batch
from frlw_evd_tpu.encode.sae import sae_init_state as jax_sae_init
from frlw_evd_tpu_torch import encode
from frlw_evd_tpu_torch.encode import common, oracle, taf
from frlw_evd_tpu_torch.encode.taf import _leaky_unit

H, W = 48, 64


def make_events(rng, n, t_lo=0.0, t_hi=1.0, h=H, w=W):
    ev = np.zeros((n, 4), dtype=np.float32)
    ev[:, 0] = rng.integers(0, w, n)
    ev[:, 1] = rng.integers(0, h, n)
    ev[:, 2] = np.sort(rng.uniform(t_lo, t_hi, n)).astype(np.float32)
    ev[:, 3] = rng.integers(0, 2, n)
    return ev


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# leaky_transform, repaired
# ---------------------------------------------------------------------------

def test_leaky_transform_matches_jax(rng):
    """The port's encode.leaky_transform is JAX's x255 function; the [0, 1]
    form the B2/B3/B5 twins use is the private _leaky_unit."""
    x = np.concatenate([-rng.uniform(0, 1, 500), -rng.uniform(1, 6000, 500),
                        [0.0, -1.0, -6000.0, -5500.0, -6100.0]])
    x = x.astype(np.float32)
    got = encode.leaky_transform(_t(x)).numpy()
    want = np.asarray(jtaf.leaky_transform(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert got.max() > 200.0                    # x255, not [0, 1]
    np.testing.assert_allclose(_leaky_unit(_t(x)).numpy() * 255.0, got,
                               rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_events_struct_to_xytp_and_padding_match_jax(rng):
    for t_field in ("t", "ts"):
        dt = np.dtype([(t_field, "<u4"), ("x", "<u2"), ("y", "<u2"),
                       ("p", "u1")])
        ev = np.zeros(50, dt)
        ev[t_field] = np.sort(rng.integers(0, 10**6, 50))
        ev["x"], ev["y"] = rng.integers(0, W, 50), rng.integers(0, H, 50)
        ev["p"] = rng.integers(0, 2, 50)
        np.testing.assert_array_equal(common.events_struct_to_xytp(ev),
                                      jcommon.events_struct_to_xytp(ev))
    xytp = make_events(rng, 300)
    for cap in (128, 512):
        got, n = common.pad_events(xytp, cap)
        want, jn = jcommon.pad_events(xytp, cap)
        np.testing.assert_array_equal(got, want)
        assert n == jn


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 2**22, 2**22 + 1, 10**7])
def test_bucket_size_matches_jax(n):
    assert common.bucket_size(n) == jcommon.bucket_size(n)


def test_valid_mask_and_flat_index_match_jax(rng):
    x = rng.integers(0, W, 40).astype(np.int32)
    y = rng.integers(0, H, 40).astype(np.int32)
    p = rng.integers(0, 2, 40).astype(np.int32)
    np.testing.assert_array_equal(common.valid_mask(25, 40).numpy(),
                                  np.asarray(jcommon.valid_mask(25, 40)))
    for kw in (dict(), dict(n_valid=25, max_events=40),
               dict(n_valid=25, max_events=40, stride_c=2)):
        got = common.flat_index(_t(x), _t(y), _t(p), _t(p), W, **kw)
        want = jcommon.flat_index(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(p), jnp.asarray(p), W, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", [((240, 304), (256, 320)),
                                     ((60, 76), (64, 96)),
                                     ((48, 64), (24, 40))])
def test_nearest_resizes_match_jax(rng, src, dst):
    chw = rng.standard_normal((3, *src)).astype(np.float32)
    np.testing.assert_array_equal(
        common.nearest_resize_chw(_t(chw), dst).numpy(),
        np.asarray(jcommon.nearest_resize_chw(jnp.asarray(chw), dst)))
    hwc = np.ascontiguousarray(chw.transpose(1, 2, 0))
    np.testing.assert_array_equal(
        common.nearest_resize_hwc(_t(hwc), dst).numpy(),
        np.asarray(jcommon.nearest_resize_hwc(jnp.asarray(hwc), dst)))
    np.testing.assert_array_equal(
        encode.nearest_resize_chw(_t(chw), dst).numpy(),
        joracle.nearest_resize(chw, dst))


def test_flat_scatters_match_jax(rng):
    """Indices past the end (OOB, 2^30) drop on both sides."""
    size = 300
    idx = rng.integers(0, size + 40, 500).astype(np.int32)
    idx[::7] = common.OOB
    vals = rng.uniform(-3, 3, 500).astype(np.float32)
    np.testing.assert_allclose(
        common.scatter_add_flat(size, _t(idx), _t(vals)).numpy(),
        np.asarray(jcommon.scatter_add_flat(size, jnp.asarray(idx),
                                            jnp.asarray(vals))), atol=1e-5)
    init = rng.uniform(-5, 0, size).astype(np.float32)
    np.testing.assert_array_equal(
        common.scatter_max_flat(_t(init), _t(idx), _t(vals)).numpy(),
        np.asarray(jcommon.scatter_max_flat(jnp.asarray(init),
                                            jnp.asarray(idx),
                                            jnp.asarray(vals))))


def test_negative_index_drops_where_jax_wraps():
    """The deliberate difference (ROADMAP §C): JAX's .at[].add(mode="drop")
    wraps an index below 0 numpy style before its bounds check, so an event
    at x = -1, y = 0 lands in the last cell of the count image; the port
    drops it."""
    ev = np.zeros((4, 4), np.float32)
    ev[0] = [-1.0, 0.0, 0.0, 0.0]        # cell -2: JAX writes cell size - 2
    ev[1] = [3.0, 2.0, 0.0, 1.0]
    got = encode.encode_count_image(_t(ev), 2, height=4, width=5).numpy()
    want = np.array(jax_count_image(jnp.asarray(ev), 2, height=4,
                                    width=5))
    assert want[3, 4, 0] == pytest.approx(0.05 * 255) and got[3, 4, 0] == 0
    np.testing.assert_allclose(got[2, 3], want[2, 3])
    want[3, 4, 0] = 0.0
    np.testing.assert_allclose(got, want)


# ---------------------------------------------------------------------------
# the offline encoders
# ---------------------------------------------------------------------------

def test_count_image_matches_jax_and_oracle(rng):
    """Enough events on a small patch to hit the clamp at 1."""
    ev = make_events(rng, 5000)
    ev[:1000, 0] = rng.integers(0, 4, 1000)
    ev[:1000, 1] = rng.integers(0, 4, 1000)
    padded, n = common.pad_events(ev, 8192)
    got = encode.encode_count_image(_t(padded), n, height=H, width=W)
    want = jax_count_image(jnp.asarray(padded), n, height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    ref = oracle.count_image(ev, (H, W))
    np.testing.assert_allclose(got.numpy().transpose(2, 0, 1), ref,
                               atol=1e-3)
    assert ref.max() == 255.0


def _batch(rng, sizes, cap, **kw):
    evs = [make_events(rng, n, **kw) for n in sizes]
    padded = np.stack([common.pad_events(e, cap)[0] for e in evs])
    return evs, padded, np.array(sizes, np.int32)


def test_count_image_batch_matches_jax(rng):
    _, padded, ns = _batch(rng, [200, 3000, 0], 4096)
    got = encode.encode_count_image_batch(_t(padded), _t(ns), height=H,
                                          width=W)
    want = jax_count_image_batch(jnp.asarray(padded), jnp.asarray(ns),
                                 height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_event_volume_matches_jax_and_oracle(rng):
    ev = make_events(rng, 3000)
    padded, n = common.pad_events(ev, 4096)
    got = encode.encode_event_volume(_t(padded), n, height=H, width=W,
                                     volume_bins=5)
    want = jax_event_volume(jnp.asarray(padded), n, height=H, width=W,
                            volume_bins=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    np.testing.assert_allclose(got.numpy().transpose(2, 0, 1),
                               oracle.event_volume(ev, (H, W), 5), atol=2e-3)


def test_event_volume_boundary_times():
    """t = 0 adds nothing; t = 1 lands in the last bin
    (test_encoders.py:59-68)."""
    ev = np.array([[1, 1, 0.0, 1], [2, 2, 1.0, 0]], dtype=np.float32)
    padded, n = common.pad_events(ev, 16)
    got = encode.encode_event_volume(_t(padded), n, height=H, width=W)
    want = jax_event_volume(jnp.asarray(padded), n, height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got[1, 1].sum() == 0.0
    assert float(got[2, 2, 9]) == pytest.approx(51.0)


def test_event_volume_batch_matches_jax(rng):
    _, padded, ns = _batch(rng, [200, 350], 512)
    got = encode.encode_event_volume_batch(_t(padded), _t(ns), height=H,
                                           width=W)
    want = jax_event_volume_batch(jnp.asarray(padded), jnp.asarray(ns),
                                  height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_sae_matches_jax_and_oracle(rng):
    """Events past the sensor (x >= W) drop, as the reference drops them."""
    now = 1_000_000.0
    ev = make_events(rng, 2000, t_lo=0, t_hi=now)
    ev[:30, 0] = W + 2.0
    padded, n = common.pad_events(ev, 2048)
    mem0 = encode.sae_init_state(H, W, now=now, device="cpu")
    np.testing.assert_array_equal(mem0.numpy(),
                                  np.asarray(jax_sae_init(H, W, now=now)))
    got, mem = encode.encode_sae(_t(padded), n, mem0, now, height=H, width=W)
    want, j_mem = jax_sae(jnp.asarray(padded), n, jax_sae_init(H, W, now=now),
                          jnp.float32(now), height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(mem.numpy(), np.asarray(j_mem), rtol=1e-6)
    ref, ref_mem = oracle.sae(ev, (H, W), [1e-5, 2.5e-6, 1e-6], None, now)
    np.testing.assert_allclose(got.numpy().transpose(2, 0, 1), ref,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mem.numpy().transpose(2, 0, 1), ref_mem,
                               rtol=1e-6)


def test_sae_memory_merge_and_batch_match_jax(rng):
    """The second window keeps pixels that fired in the first
    (test_encoders.py:119-139), batched over two streams."""
    now1, now2 = 500_000.0, 1_000_000.0
    _, p1, n1 = _batch(rng, [500, 300], 512, t_lo=0, t_hi=now1)
    _, p2, n2 = _batch(rng, [500, 450], 512, t_lo=now1, t_hi=now2)
    mem = encode.sae_init_state(H, W, now=now1, device="cpu").expand(
        2, H, W, 2)
    j_mem = jnp.broadcast_to(jax_sae_init(H, W, now=now1), (2, H, W, 2))
    for p, n, now in ((p1, n1, now1), (p2, n2, now2)):
        got, mem = encode.encode_sae_batch(_t(p), _t(n), mem, now, height=H,
                                           width=W, lamdas=(1e-5,))
        want, j_mem = jax_sae_batch(jnp.asarray(p), jnp.asarray(n), j_mem,
                                    jnp.full(2, now, jnp.float32), height=H,
                                    width=W, lamdas=(1e-5,))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(mem.numpy(), np.asarray(j_mem), rtol=1e-6)


def test_taf_bin_step_matches_jax_and_oracle(rng):
    """Three bins from a fresh queue; the third has no event (the freeze)."""
    K = 8
    st = taf.taf_init_state(H, W, K, device="cpu")
    j_st = jtaf.taf_init_state(H, W, K)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    o_st = oracle.taf_init_state((H, W), K)
    for i, n in enumerate((600, 400, 0)):
        ev = make_events(rng, 600)
        padded, _ = common.pad_events(ev, 1024)
        st = taf.taf_bin_step(st, _t(padded), n)
        j_st = jtaf.taf_bin_step(j_st, jnp.asarray(padded), n)
        o_st = oracle.taf_bin(ev[:n], (H, W), o_st)
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=2e-3,
                                   err_msg=f"bin {i}")
        np.testing.assert_allclose(st.numpy(), o_st, atol=2e-3)


def test_taf_window_and_volume_match_jax(rng):
    """bucket_events_for_taf → encode_taf_window → taf_state_to_volume over
    a 50 ms window of 10 ms bins, carried into a second window."""
    K, bin_us = 8, 10_000
    st = taf.taf_init_state(H, W, K, device="cpu")
    j_st = jtaf.taf_init_state(H, W, K)
    for w0 in (0, 50_000):
        ev = make_events(rng, 4000, t_lo=w0, t_hi=w0 + 50_000)
        binned, nv = taf.bucket_events_for_taf(ev, w0, w0 + 50_000, bin_us,
                                               1024)
        j_binned, j_nv = jtaf.bucket_events_for_taf(ev, w0, w0 + 50_000,
                                                    bin_us, 1024)
        np.testing.assert_array_equal(binned, j_binned)
        np.testing.assert_array_equal(nv, j_nv)
        st = encode.encode_taf_window(st, _t(binned), _t(nv))
        j_st = jtaf.encode_taf_window(j_st, jnp.asarray(binned),
                                      jnp.asarray(nv))
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=2e-3)
    vol = taf.taf_state_to_volume(st)
    j_vol = jtaf.taf_state_to_volume(j_st)
    assert vol.shape == (H, W, 2 * K)
    np.testing.assert_allclose(vol.numpy(), np.asarray(j_vol), rtol=1e-6,
                               atol=2e-3 * 255 / 8.7)


# ---------------------------------------------------------------------------
# the oracle, the port's own copy
# ---------------------------------------------------------------------------

ORACLE_CASES = ["event_volume", "count_image", "sae", "taf_bin",
                "taf_window", "leaky_transform", "taf_blob", "to_uint8",
                "nearest_resize"]


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_oracle_copy_equals_jax_oracle(rng, name):
    ev = make_events(rng, 800)
    ev_us = make_events(rng, 800, 0, 50_000)
    state = rng.uniform(-50, 0, (H, W, 2, 8)).astype(np.float32)
    args = {
        "event_volume": (ev, (H, W), 5),
        "count_image": (ev, (H, W)),
        "sae": (ev_us, (H, W), [1e-5, 1e-6], None, 50_000.0),
        "taf_bin": (ev, (H, W), state),
        "taf_window": (ev_us, (H, W), 0, 50_000, 10_000, state),
        "leaky_transform": (-rng.uniform(0, 100, (4, 5)),),
        "taf_blob": (state.transpose(3, 2, 0, 1).reshape(16, H, W), 8,
                     (56, 72)),
        "to_uint8": (rng.uniform(-10, 300, (3, 4)),),
        "nearest_resize": (rng.standard_normal((2, H, W)), (50, 70)),
    }[name]
    got = getattr(oracle, name)(*args)
    want = getattr(joracle, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
