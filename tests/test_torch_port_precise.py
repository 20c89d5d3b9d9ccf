"""The port's exact-t and sorted encode paths against the JAX package, CPU.

Kernel B6 (`scatter_cnt_tsum_pallas_sorted`, precise=True) and kernel B8
(`scatter_cnt_tsum_pallas`) against their Pallas originals, the plain
`scatter_cnt_tsum_sorted` against `mxu_scatter.scatter_cnt_tsum_sorted`,
kernel B5 (`taf_update_leaky_v2`) against its Pallas original and against
B3's twin, and the p64 and GEN1 steps on their precise and sorted paths
against the JAX steps over windows carrying state. The Pallas calls run in
interpret mode; the port runs its kernels' plain twins.

Tolerances, and why:
  * counts exact everywhere;
  * B6 and B8 t-sums: atol 1e-3, rtol 5e-3, the JAX package's own gate for
    its precise kernels (tests/test_pallas_scatter.py:35, :80): the TPU sums
    bf16 hi + lo columns, about 2^-17 relative per addend, the port exact t;
  * `scatter_cnt_tsum_sorted`: the same bf16-rounded addends on both sides
    and f32 sums, except that the JAX fallback for the events its sorted
    bands miss adds its value columns unrounded (mxu_scatter.py:299-315):
    at most 2^-9 an event with one bf16 column (precise=False), 2^-17 with
    hi + lo; so cnt * 2^-8 and cnt * 2^-15;
  * B5 from identical planes: state exact, volume one bf16 ulp (2^-8,
    log1p rounding); B5's twin equals B3's twin exactly;
  * steps: state atol 1e-2, volume 2e-2, the gates of
    tests/test_torch_port_p64.py and tests/test_torch_port_encode.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frlw_evd_tpu.encode import mxu_scatter, pallas_scatter, pallas_update
from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.encode import (init_state, p64_init_state,
                                       scatter_cnt_tsum_pallas,
                                       scatter_cnt_tsum_pallas_sorted,
                                       scatter_cnt_tsum_sorted,
                                       taf_stream_step_kernel,
                                       taf_stream_step_kernel_p64,
                                       taf_update_leaky_raw_plain,
                                       taf_update_leaky_v2,
                                       taf_update_leaky_v2_plain)

K = 8


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas calls in interpret mode, as tests/test_pallas_scatter.py
    runs them."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    for mod in (pallas_scatter, pallas_update):
        monkeypatch.setattr(mod.pl, "pallas_call", interp_call)


def _cells(rng, dist, B, E, size):
    """The index distributions of test_pallas_scatter.py:38-68."""
    if dist == "uniform":
        idx = rng.integers(0, size, (B, E))
    elif dist == "one_cell":
        idx = np.full((B, E), 12345)
    elif dist == "striped":
        idx = (np.arange(B * E).reshape(B, E) * 997) % size
    else:
        idx = rng.integers(0, 300, (B, E))
    tv = rng.uniform(-1, 0, (B, E)).astype(np.float32)
    return idx.astype(np.int32), tv, rng.random((B, E)) < 0.9


def _both(fn_port, fn_jax, idx, tv, valid, *args):
    cnt, tsum = fn_port(torch.from_numpy(idx), torch.from_numpy(tv),
                        torch.from_numpy(valid), *args)
    j_cnt, j_tsum = fn_jax(jnp.asarray(idx), jnp.asarray(tv),
                           jnp.asarray(valid), *args)
    assert cnt.dtype == tsum.dtype == torch.float32
    assert cnt.shape == tuple(j_cnt.shape) and tsum.shape == cnt.shape
    return cnt.numpy(), tsum.numpy(), np.asarray(j_cnt), np.asarray(j_tsum)


@pytest.mark.parametrize("dist", ["uniform", "one_cell", "striped",
                                  "low_band"])
def test_pair_sorted_scatter_matches_pallas(rng, interpret, dist):
    """B6 against scatter_cnt_tsum_pallas_sorted(precise=True), size 45,000,
    B = 2, E = 2100 (not a multiple of the chunk), 10% invalid slots and a
    few out of range."""
    idx, tv, valid = _cells(rng, dist, 2, 2100, 45_000)
    idx[0, :7] = -3
    idx[1, :7] = 45_000
    cnt, tsum, j_cnt, j_tsum = _both(
        scatter_cnt_tsum_pallas_sorted,
        pallas_scatter.scatter_cnt_tsum_pallas_sorted, idx, tv, valid, 45_000,
        True)
    np.testing.assert_array_equal(cnt, j_cnt, err_msg=f"{dist} cnt")
    np.testing.assert_allclose(tsum, j_tsum, atol=1e-3, rtol=5e-3,
                               err_msg=f"{dist} tsum")
    ok = valid & (idx >= 0) & (idx < 45_000)
    assert cnt.sum() == ok.sum()


def test_dense_scatter_matches_pallas(rng, interpret):
    """B8 against scatter_cnt_tsum_pallas at test_pallas_scatter.py:23-35's
    size (B = 2, E = 2048, 5000 cells), with out-of-range indices, and
    against an exact numpy histogram."""
    B, E, size = 2, 2048, 5000
    idx = rng.integers(0, size, (B, E)).astype(np.int32)
    idx[0, :5] = [-1, size, size + 200, -7, 2**30]
    tv = rng.uniform(-1, 0, (B, E)).astype(np.float32)
    valid = rng.random((B, E)) < 0.9
    cnt, tsum, j_cnt, j_tsum = _both(
        scatter_cnt_tsum_pallas, pallas_scatter.scatter_cnt_tsum_pallas, idx,
        tv, valid, size)
    np.testing.assert_array_equal(cnt, j_cnt)
    np.testing.assert_allclose(tsum, j_tsum, atol=1e-3, rtol=5e-3)
    ok = valid & (idx >= 0) & (idx < size)
    for b in range(B):
        ref = np.zeros(size)
        np.add.at(ref, idx[b][ok[b]], tv[b][ok[b]].astype(np.float64))
        np.testing.assert_allclose(tsum[b], ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("dist", ["uniform", "striped"])
def test_sorted_histogram_matches_xla(rng, precise, dist):
    """scatter_cnt_tsum_sorted against mxu_scatter.scatter_cnt_tsum_sorted,
    both precise values; "striped" makes the JAX banded path overflow."""
    idx, tv, valid = _cells(rng, dist, 2, 2100, 45_000)
    cnt, tsum, j_cnt, j_tsum = _both(
        scatter_cnt_tsum_sorted, mxu_scatter.scatter_cnt_tsum_sorted, idx, tv,
        valid, 45_000, precise)
    np.testing.assert_array_equal(cnt, j_cnt)
    np.testing.assert_array_less(np.abs(tsum - j_tsum),
                                 j_cnt * 2.0 ** (-15 if precise else -8)
                                 + 1e-7)
    if not precise:   # one bf16 column: far from exact t
        assert np.abs(tsum - scatter_cnt_tsum_pallas_sorted(
            torch.from_numpy(idx), torch.from_numpy(tv),
            torch.from_numpy(valid), 45_000)[1].numpy()).max() > 1e-4


def _v2_inputs(rng, B=3, H2=4, W2=16):
    """A p64 queue with some cells at -6000, count/t-sum planes in (pixel,
    subpixel, polarity) order, stream 1 without events (the freeze)."""
    state = np.where(rng.random((B, H2, W2 * 64)) < 0.2, -6000.0,
                     rng.uniform(-40, 0, (B, H2, W2 * 64))).astype(np.float32)
    cnt = rng.integers(0, 4, (B, H2, W2 * 8)).astype(np.float32)
    cnt[1] = 0.0
    tsum = (cnt * rng.uniform(-1, 0, cnt.shape)).astype(np.float32)
    any_ev = (cnt.reshape(B, -1).sum(1) > 0).astype(np.int32)
    assert any_ev.tolist() == [1, 0, 1][:B]
    return state, cnt, tsum, any_ev


def test_plane_update_matches_pallas_v2(rng, interpret):
    """B5's twin against taf_update_leaky_v2 from identical planes, with
    JAX's height = H/2 and width = (W/2)*4 (pallas_update.py:379-380)."""
    state, cnt, tsum, any_ev = _v2_inputs(rng)
    B, H2, WF = state.shape
    st = torch.from_numpy(state.copy())
    out, vol = taf_update_leaky_v2(st, torch.from_numpy(cnt),
                                   torch.from_numpy(tsum),
                                   torch.from_numpy(any_ev), height=H2,
                                   width=WF // 16)
    assert out is st and vol.dtype == torch.bfloat16 and vol.shape == st.shape
    j_state, j_vol = pallas_update.taf_update_leaky_v2(
        jnp.asarray(state), jnp.asarray(cnt), jnp.asarray(tsum),
        jnp.asarray(any_ev, jnp.float32), height=H2, width=WF // 16)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_state))
    np.testing.assert_array_equal(st.numpy()[1], state[1])    # the freeze
    np.testing.assert_allclose(vol.float().numpy(),
                               np.asarray(j_vol, np.float32), atol=2.0 ** -8)


def test_plane_update_twin_equals_raw_update_twin(rng):
    """B5's twin (expansion matrix) and B3's twin (cell → channel index map)
    on the same planes: the same state and volume, bit for bit."""
    state, cnt, tsum, any_ev = _v2_inputs(rng, B=2, H2=6, W2=32)
    B, H2, WF = state.shape
    s5, s3 = torch.from_numpy(state.copy()), torch.from_numpy(state.copy())
    _, v5 = taf_update_leaky_v2_plain(
        s5, torch.from_numpy(cnt), torch.from_numpy(tsum),
        torch.from_numpy(any_ev), height=H2, width=WF // 16)
    _, v3 = taf_update_leaky_raw_plain(
        s3, torch.from_numpy(cnt).reshape(B, -1),
        torch.from_numpy(tsum).reshape(B, -1), torch.from_numpy(any_ev),
        height=2 * H2, width=WF // 32)
    assert torch.equal(s5, s3) and torch.equal(v5, v3)


@pytest.mark.parametrize("height,width,wf",
                         [(8, 40, 20 * 64), (8, 64, 32 * 32)],
                         ids=["w2_not_16", "k4"])
def test_plane_update_refuses_what_the_kernel_refuses(height, width, wf):
    """(W/2) % 16 != 0 and K != 8 raise (pallas_update.py:205-207)."""
    H2, W2 = height // 2, width // 2
    st = torch.zeros(1, H2, wf)
    cnt = torch.zeros(1, H2, W2 * 8)
    with pytest.raises(ValueError, match="taf_update_leaky_v2 needs"):
        taf_update_leaky_v2(st, cnt, cnt, torch.ones(1, dtype=torch.int32),
                            height=H2, width=W2 * 4)


def _events(rng, B, E, H, W):
    ev = np.zeros((B, E, 4), np.float32)
    ev[..., 0] = rng.integers(0, W, (B, E))
    ev[..., 1] = rng.integers(0, H, (B, E))
    ev[..., 2] = np.sort(rng.uniform(0, 1, (B, E)), axis=1)
    ev[..., 3] = rng.integers(0, 2, (B, E))
    return ev


@pytest.mark.parametrize("p64,scatter,precise", [
    (True, "pallas", True), (True, "sorted", False), (True, "sorted", True),
    (False, "pallas", True), (False, "sorted", False)],
    ids=["p64-pallas-precise", "p64-sorted", "p64-sorted-precise",
         "gen1-pallas-precise", "gen1-sorted"])
def test_step_matches_jax_over_windows(rng, interpret, p64, scatter, precise):
    """The steps off B1 against the JAX steps, three windows carrying
    state: full, partial with out-of-range events, and one with stream 1
    empty (the freeze)."""
    B, E = 2, 800
    H, W = (32, 64) if p64 else (30, 36)
    kw = dict(height=H, width=W, scatter=scatter, precise=precise)
    if p64:
        st = p64_init_state(B, H, W, device="cpu")
        step, j_step = taf_stream_step_kernel_p64, \
            pallas_update.taf_stream_step_kernel_p64
    else:
        st = init_state(B, H, W, K, device="cpu")
        step, j_step = taf_stream_step_kernel, \
            pallas_update.taf_stream_step_kernel
    j_st = jnp.array(st.numpy())           # a copy: st is updated in place
    for i, n1 in enumerate((E, 300, 0)):
        ev = _events(rng, B, E, H, W)
        ev[0, :30, 0] = W + 1.0
        ev[1, :30, 3] = 2.0
        nv = np.array([E, n1], np.int32)
        prev = st.clone()
        st, vol = step(st, torch.from_numpy(ev), torch.from_numpy(nv), **kw)
        j_st, j_vol = j_step(j_st, jnp.asarray(ev), jnp.asarray(nv), **kw)
        assert vol.shape == j_vol.shape and vol.dtype == torch.bfloat16
        np.testing.assert_allclose(st.numpy(), np.asarray(j_st), atol=1e-2,
                                   err_msg=f"state, window {i}")
        np.testing.assert_allclose(vol.float().numpy(),
                                   np.asarray(j_vol, np.float32), atol=2e-2,
                                   err_msg=f"volume, window {i}")
        if n1 == 0:
            torch.testing.assert_close(st[1], prev[1], rtol=0, atol=0)


def test_precise_step_keeps_exact_t(rng):
    """B6 on the step's cells gives the same histogram as B1 up to f32
    order, so the precise p64 step and the raw one agree to rounding."""
    B, E, H, W = 2, 800, 32, 64
    ev = _events(rng, B, E, H, W)
    nv = np.array([E, 500], np.int32)
    states = {}
    for precise in (False, True):
        st = p64_init_state(B, H, W, device="cpu")
        st, vol = taf_stream_step_kernel_p64(st, torch.from_numpy(ev),
                                             torch.from_numpy(nv), height=H,
                                             width=W, precise=precise)
        states[precise] = st
    torch.testing.assert_close(states[True], states[False], rtol=0,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("p64", [True, False], ids=["p64", "gen1"])
def test_steps_refuse_an_unknown_scatter(p64):
    """Only JAX's scatter values, 'pallas' and 'sorted', are taken
    (pallas_update.py:126-130, :367-369)."""
    ev = torch.zeros(1, 16, 4)
    nv = torch.ones(1, dtype=torch.int32)
    if p64:
        st = p64_init_state(1, 32, 64, device="cpu")
        step = taf_stream_step_kernel_p64
    else:
        st = init_state(1, 8, 8, K, device="cpu")
        step = taf_stream_step_kernel
    for bad in ("mxu", "xla", "Pallas"):
        with pytest.raises(ValueError, match="'pallas' or 'sorted'"):
            step(st, ev, nv, height=st.shape[1] * (2 if p64 else 1),
                 width=64 if p64 else 8, scatter=bad)


def test_pair_sorted_entry_refuses_the_packed_form():
    """precise=False is kernel B1, which takes events: the cell-index entry
    refuses it, naming the entry to call."""
    idx = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="scatter_cnt_tsum"):
        scatter_cnt_tsum_pallas_sorted(idx, torch.zeros(1, 4),
                                       torch.ones(1, 4, dtype=torch.bool), 8,
                                       precise=False)


@pytest.mark.parametrize("p64", [True, False], ids=["p64", "gen1"])
def test_pipelines_pass_scatter_through(monkeypatch, p64):
    """make_pipeline_p64 / make_pipeline_kernel hand their scatter to the
    step with precise=False, as bench.py's factories do."""
    from frlw_evd_tpu_torch.models import build_detector

    seen = []

    def spy(*args, **kw):
        seen.append((kw["scatter"], kw["precise"]))
        raise RuntimeError("stop")

    narrow = dict(in_channels=(16, 16, 16), stem_out_channels=8,
                  head_width=16)
    if p64:
        monkeypatch.setattr(pipeline, "taf_stream_step_kernel_p64", spy)
        model = build_detector(2, stem="bfm_folded", **narrow)
        run = pipeline.make_pipeline_p64(model, (64, 96), "sorted",
                                         folded=True, device="cpu")
    else:
        monkeypatch.setattr(pipeline, "taf_stream_step_kernel", spy)
        model = build_detector(2, stem="bfm", **narrow)
        run = pipeline.make_pipeline_kernel(model, (60, 72), (64, 96),
                                            "sorted", device="cpu")
    with pytest.raises(RuntimeError, match="stop"):
        run(None, None, None)
    assert seen == [("sorted", False)]
