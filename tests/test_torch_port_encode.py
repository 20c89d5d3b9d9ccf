"""Port encode kernels' plain twins against the JAX package on the CPU.

Kernel B1 (`scatter_cnt_tsum`) is held against the banded Pallas scatter
`scatter_cnt_tsum_pallas_sorted(precise=False)`, kernel B2
(`taf_update_leaky`) against the fused Pallas update, and the full step
(`taf_stream_step_kernel`) against its JAX counterpart. The Pallas kernels
run in interpret mode on the CPU backend that conftest.py forces.

Tolerances:
  * counts are exact on both sides;
  * t-sums: the JAX path quantises t to 12 bits ((t+1)·4095 rounded) and
    rounds it to bf16 before summing, the port sums exact f32 t - 1; per
    event that is at most 2^-9 + 1/(2·4095) < 2.5e-3, so |Δtsum| <= cnt·2.5e-3;
  * the state after one update from identical planes is exact; the volume
    may differ by one bf16 ulp (2^-8) where log1p rounds differently;
  * the full step carries the t difference into the bf16 mean: state atol
    1e-2 (one bf16 ulp of tm plus the t error), volume atol 2e-2 (the JAX
    package's own pipeline gate, tests/test_bench_pipelines.py:100-105).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.encode.pallas_scatter import scatter_cnt_tsum_pallas_sorted
from frlw_evd_tpu.encode.pallas_update import taf_stream_step_kernel \
    as jax_step
from frlw_evd_tpu.encode.pallas_update import taf_update_leaky as jax_update
from frlw_evd_tpu_torch.encode import (init_state, scatter_cnt_tsum,
                                       taf_stream_step_kernel,
                                       taf_update_leaky)
from frlw_evd_tpu_torch.pipeline import synth_events, synth_events_skewed

K = 8
T_TOL = 2.5e-3


def _jax_cells(xytp, n_valid, height, width):
    """idx / t-1 / valid as the JAX TAF step derives them
    (encode/pallas_update.py:111-119)."""
    ev = jnp.asarray(xytp)
    E = ev.shape[1]
    x = ev[..., 0].astype(jnp.int32)
    y = ev[..., 1].astype(jnp.int32)
    p = ev[..., 3].astype(jnp.int32)
    valid = ((jnp.arange(E)[None, :] < jnp.asarray(n_valid)[:, None])
             & (x >= 0) & (x < width) & (y >= 0) & (y < height)
             & (p >= 0) & (p < 2))
    P = height * width * 2
    idx = jnp.where(valid, (y * width + x) * 2 + p, jnp.int32(P))
    return idx, (ev[..., 2] - 1.0) * valid, valid


def _events_for_cells(rng, idx, width):
    """xytp whose cells are `idx` (cell = (y*W + x)*2 + p), t ~ U[0, 1)."""
    cell, p = np.divmod(idx, 2)
    y, x = np.divmod(cell, width)
    ev = np.stack([x, y, rng.uniform(0, 1, idx.shape), p], -1)
    return ev.astype(np.float32)


@pytest.mark.parametrize("dist", ["uniform", "one_cell", "striped",
                                  "low_band"])
def test_scatter_matches_pallas_sorted(rng, dist):
    """The distributions of test_pallas_scatter.py:41-75 at its size
    (45,000 cells = a 150x150 sensor, B = 2, E = 2100), plus a partial
    n_valid and out-of-range x / y / p."""
    H, W = 150, 150
    size = H * W * 2
    B, E = 2, 2100
    if dist == "uniform":
        idx = rng.integers(0, size, (B, E))
    elif dist == "one_cell":
        idx = np.full((B, E), 12345)
    elif dist == "striped":
        idx = (np.arange(B * E).reshape(B, E) * 997) % size
    else:
        idx = rng.integers(0, 300, (B, E))
    xytp = _events_for_cells(rng, idx, W)
    # out-of-range coordinates and polarities, and x = -0.5 (truncates to
    # cell column 0, so it counts)
    bad = rng.random((B, E)) < 0.1
    xytp[..., 0] = np.where(bad, rng.choice([-3.0, W + 2.0, -0.5], (B, E)),
                            xytp[..., 0])
    xytp[..., 1] = np.where(rng.random((B, E)) < 0.03, H + 1.0, xytp[..., 1])
    xytp[..., 3] = np.where(rng.random((B, E)) < 0.03, 2.0, xytp[..., 3])
    n_valid = np.array([E, 1500], np.int32)

    cnt, tsum, any_ev = scatter_cnt_tsum(torch.from_numpy(xytp),
                                         torch.from_numpy(n_valid),
                                         height=H, width=W)
    j_idx, j_tv, j_valid = _jax_cells(xytp, n_valid, H, W)
    j_cnt, j_tsum = scatter_cnt_tsum_pallas_sorted(j_idx, j_tv, j_valid,
                                                   size, False)
    j_cnt, j_tsum = np.asarray(j_cnt), np.asarray(j_tsum)

    np.testing.assert_array_equal(cnt.numpy(), j_cnt, err_msg=f"{dist} cnt")
    np.testing.assert_array_less(np.abs(tsum.numpy() - j_tsum),
                                 j_cnt * T_TOL + 1e-6, err_msg=f"{dist} tsum")
    np.testing.assert_array_equal(any_ev.numpy(),
                                  np.asarray(j_valid).any(1).astype(np.int32))
    assert (j_cnt.sum(1) == np.asarray(j_valid).sum(1)).all()

    # and against an exact numpy histogram: the port keeps exact t
    ref = np.zeros((B, size))
    valid = np.asarray(j_valid)
    for b in range(B):
        np.add.at(ref[b], np.asarray(j_idx)[b][valid[b]],
                  xytp[b, valid[b], 2].astype(np.float64) - 1.0)
    np.testing.assert_allclose(tsum.numpy(), ref, rtol=2e-4, atol=1e-5)


def test_update_matches_pallas_update(rng):
    """B2's twin against taf_update_leaky from identical count / t-sum
    planes, with one stream frozen (no events)."""
    B, H, W = 3, 8, 24
    P = H * W * 2
    state = np.where(rng.random((B, H, W * 2 * K)) < 0.2, -6000.0,
                     rng.uniform(-40, 0, (B, H, W * 2 * K))).astype(np.float32)
    cnt = rng.integers(0, 4, (B, P)).astype(np.float32)
    cnt[1] = 0.0                                        # stream 1: frozen
    tsum = (cnt * rng.uniform(-1, 0, (B, P))).astype(np.float32)
    any_ev = (cnt.sum(1) > 0).astype(np.int32)
    assert any_ev.tolist() == [1, 0, 1]

    st_t = torch.from_numpy(state.copy())
    st_out, vol = taf_update_leaky(st_t, torch.from_numpy(cnt),
                                   torch.from_numpy(tsum),
                                   torch.from_numpy(any_ev), height=H, width=W)
    assert st_out is st_t                               # updated in place

    cnt4 = jnp.asarray(cnt).reshape(B, H, W, 2)
    tm4 = jnp.where(cnt4 > 0, jnp.asarray(tsum).reshape(B, H, W, 2)
                    / (cnt4 + 1e-8), -2.0).astype(jnp.bfloat16)
    tm_f = jnp.tile(tm4, (1, 1, 1, K)).reshape(B, H, W * 2 * K)
    j_state, j_vol = jax_update(jnp.asarray(state), tm_f,
                                jnp.asarray(any_ev, jnp.float32),
                                height=H, width=W)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(j_state))
    np.testing.assert_array_equal(st_t.numpy()[1], state[1])   # the freeze
    np.testing.assert_allclose(vol.float().numpy(),
                               np.asarray(j_vol, np.float32), atol=2.0 ** -8)
    assert vol.dtype == torch.bfloat16


def test_stream_step_matches_jax_over_windows():
    """taf_stream_step_kernel at the mini-GEN1 geometry of
    test_bench_pipelines.py:78-105 (60x72, B = 2, E = 1024) over three
    windows carrying state: uniform, skewed + out-of-range, all empty."""
    H, W = 60, 72
    B, E = 2, 1024
    ev_u, nv_u = synth_events(np.random.default_rng(1), 1, B, E, (H, W))
    ev_s, nv_s = synth_events_skewed(np.random.default_rng(2), 1, B, E,
                                     (H, W))
    ev_s[0, 0, :50, 0] = -2.0                           # out of range
    ev_s[0, 1, :50, 3] = 3.0
    windows = [(ev_u[0], nv_u[0]), (ev_s[0], nv_s[0]),
               (ev_u[0], np.zeros(B, np.int32))]        # all-empty window

    st = init_state(B, H, W, K, device="cpu")
    j_st = jnp.full((B, H, W * 2 * K), -6000.0, jnp.float32)
    for i, (ev, nv) in enumerate(windows):
        prev = st.clone()
        st, vol = taf_stream_step_kernel(st, torch.from_numpy(ev),
                                         torch.from_numpy(nv), height=H,
                                         width=W)
        j_st, j_vol = jax_step(j_st, jnp.asarray(ev), jnp.asarray(nv),
                               height=H, width=W, scatter="pallas",
                               precise=False)
        assert vol.shape == (B, H, W, 2 * K) and vol.dtype == torch.bfloat16
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=1e-2,
                                   err_msg=f"state, window {i}")
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        if i == 2:
            torch.testing.assert_close(st, prev, rtol=0, atol=0)  # frozen
