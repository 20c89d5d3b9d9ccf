"""Port kernels on the card against their plain twins (marker `cuda`).

These tests need an NVIDIA GPU with nvcc and skip elsewhere. They import
no JAX, so on a machine without it they run with conftest.py left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: counts exact; t-sums within the f32 reordering bound
cnt^2 * 2^-23 (atomics add in a run-dependent order; B6 sums each run in
sorted order against the twin's f64 sum, cnt^2 * 2^-24, and repeats bit for
bit); the updates' state exact; volumes within one bf16 ulp (2^-8); B5
equal to B3 on the same planes, bit for bit; the BFM chain (B4, B7) within
atol 1e-2 + rtol 1e-2 (a bf16-rounded intermediate may round the other way
where the twin sums in another order), B4's pad channels exactly zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.encode import (
    scatter_cnt_tsum, scatter_cnt_tsum_pallas, scatter_cnt_tsum_pallas_plain,
    scatter_cnt_tsum_pallas_sorted, scatter_cnt_tsum_pallas_sorted_plain,
    scatter_cnt_tsum_plain, taf_update_leaky, taf_update_leaky_plain,
    taf_update_leaky_raw, taf_update_leaky_raw_plain, taf_update_leaky_v2,
    taf_update_leaky_v2_plain)
from frlw_evd_tpu_torch.encode.scatter import event_cells
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models.stem_chain import (
    bfm_chain_apply, bfm_chain_apply_folded, bfm_chain_apply_folded_plain,
    bfm_chain_apply_plain)
from frlw_evd_tpu_torch.models.stems import BinsFusionModuleFolded

pytestmark = pytest.mark.cuda

SENSOR, INPUT = (60, 72), (64, 96)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels build with nvcc for sm_90a)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _events(B=4, E=4096, seed=0):
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(seed), 1, B,
                                          E, SENSOR)
    ev[0, 0, :64, 0] = -1.5                  # out of range
    ev[0, 1, :64, 3] = 2.0
    return torch.from_numpy(ev[0]), torch.from_numpy(nv[0])


P64_SENSOR = (64, 96)


@pytest.mark.parametrize("layout", ["folded", "p64"])
def test_scatter_kernel_matches_twin(cuda, layout):
    ev, nv = _events()
    ev, nv = ev.to(cuda), nv.to(cuda)
    before = scatter_cnt_tsum.launches
    cnt, tsum, anyv = scatter_cnt_tsum(ev, nv, height=SENSOR[0],
                                       width=SENSOR[1], layout=layout)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum.launches == before + 1
    p_cnt, p_tsum, p_any = scatter_cnt_tsum_plain(ev, nv, height=SENSOR[0],
                                                  width=SENSOR[1],
                                                  layout=layout)
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert (anyv == p_any).all()
    assert ((tsum - p_tsum).abs() <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()


@pytest.mark.parametrize("C", [16, 8])
def test_update_kernel_matches_twin(cuda, C):
    """B2 at 2K = 16 and 8 on 3 streams, so the last block of threads has
    a tail of inactive lanes; stream 2 frozen."""
    ev, nv = _events()
    nv[2] = 0                                 # frozen stream
    ev, nv = ev[:3].contiguous().to(cuda), nv[:3].to(cuda)
    H, W = SENSOR
    cnt, tsum, anyv = scatter_cnt_tsum_plain(ev, nv, height=H, width=W)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = -40.0 * torch.rand(3, H, W * C, device=cuda, generator=g)
    plain_state = state.clone()
    frozen = state[2].clone()
    before = taf_update_leaky.launches
    _, vol = taf_update_leaky(state, cnt, tsum, anyv, height=H, width=W)
    _, p_vol = taf_update_leaky_plain(plain_state, cnt, tsum, anyv, height=H,
                                      width=W)
    torch.cuda.synchronize()
    assert taf_update_leaky.launches == before + 1
    torch.testing.assert_close(state, plain_state, rtol=0, atol=0)
    torch.testing.assert_close(state[2], frozen, rtol=0, atol=0)
    torch.testing.assert_close(vol.float(), p_vol.float(), rtol=0,
                               atol=2.0 ** -8)


def test_raw_update_kernel_matches_twin(cuda):
    """B3 on the p64 queue from B1's p64 planes, stream 2 frozen."""
    H, W = P64_SENSOR
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(1), 1, 4,
                                          4096, P64_SENSOR)
    ev, nv = torch.from_numpy(ev[0]).to(cuda), torch.from_numpy(nv[0])
    nv[2] = 0
    nv = nv.to(cuda)
    cnt, tsum, anyv = scatter_cnt_tsum_plain(ev, nv, height=H, width=W,
                                             layout="p64")
    g = torch.Generator(device=cuda).manual_seed(0)
    state = -40.0 * torch.rand(4, H // 2, W // 2 * 64, device=cuda,
                               generator=g)
    plain_state = state.clone()
    frozen = state[2].clone()
    before = taf_update_leaky_raw.launches
    _, vol = taf_update_leaky_raw(state, cnt, tsum, anyv, height=H, width=W)
    _, p_vol = taf_update_leaky_raw_plain(plain_state, cnt, tsum, anyv,
                                          height=H, width=W)
    torch.cuda.synchronize()
    assert taf_update_leaky_raw.launches == before + 1
    torch.testing.assert_close(state, plain_state, rtol=0, atol=0)
    torch.testing.assert_close(state[2], frozen, rtol=0, atol=0)
    torch.testing.assert_close(vol.float(), p_vol.float(), rtol=0,
                               atol=2.0 ** -8)


def _cells(cuda, layout):
    """Cell indices, t - 1 and valid of skewed events with some out of
    range, in one cell order, on the card."""
    ev, nv = _events()
    H, W = P64_SENSOR if layout == "p64" else SENSOR
    ev[..., 0] = ev[..., 0] * (W / SENSOR[1])
    ev[..., 1] = ev[..., 1] * (H / SENSOR[0])
    idx, tv, valid = event_cells(ev.to(cuda), nv.to(cuda), H, W, layout)
    return idx, tv, valid, H * W * 2


@pytest.mark.parametrize("layout", ["folded", "p64"])
def test_pair_sorted_scatter_matches_twin_and_repeats(cuda, layout):
    """B6 against its twin, a one-cell stream included, and two launches
    bitwise equal."""
    idx, tv, valid, size = _cells(cuda, layout)
    idx[3] = 1234                              # one long run
    before = scatter_cnt_tsum_pallas_sorted.launches
    cnt, tsum = scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
    cnt2, tsum2 = scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_sorted_plain(idx, tv, valid, size)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum_pallas_sorted.launches == before + 2
    assert torch.equal(cnt, cnt2) and torch.equal(tsum, tsum2)
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert ((tsum - p_tsum).abs() <= p_cnt * p_cnt * 2.0 ** -24).all()
    assert int(p_cnt[3].max()) == int(valid[3].sum())


def test_dense_scatter_matches_twin(cuda):
    """B8 against its twin on the folded cells, with a size that is not a
    multiple of the kernel's tile."""
    idx, tv, valid, size = _cells(cuda, "folded")
    before = scatter_cnt_tsum_pallas.launches
    cnt, tsum = scatter_cnt_tsum_pallas(idx, tv, valid, size)
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_plain(idx, tv, valid, size)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum_pallas.launches == before + 1
    assert size % 6144
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert ((tsum - p_tsum).abs() <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()


def test_plane_update_kernel_matches_twin_and_b3(cuda):
    """B5 against its twin, stream 2 frozen; and B5 on B1's p64 planes
    equal to B3 on the same planes, bit for bit."""
    H, W = P64_SENSOR
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(1), 1, 4,
                                          4096, P64_SENSOR)
    ev, nv = torch.from_numpy(ev[0]).to(cuda), torch.from_numpy(nv[0])
    nv[2] = 0
    cnt, tsum, anyv = scatter_cnt_tsum(ev, nv.to(cuda), height=H, width=W,
                                       layout="p64")
    g = torch.Generator(device=cuda).manual_seed(0)
    state = -40.0 * torch.rand(4, H // 2, W // 2 * 64, device=cuda,
                               generator=g)
    states = {k: state.clone() for k in ("v2", "plain", "raw")}
    planes = (cnt.view(4, H // 2, -1), tsum.view(4, H // 2, -1), anyv)
    hw = dict(height=H // 2, width=W // 2 * 4)
    before = taf_update_leaky_v2.launches
    _, vol = taf_update_leaky_v2(states["v2"], *planes, **hw)
    _, p_vol = taf_update_leaky_v2_plain(states["plain"], *planes, **hw)
    _, r_vol = taf_update_leaky_raw(states["raw"], cnt, tsum, anyv, height=H,
                                    width=W)
    torch.cuda.synchronize()
    assert taf_update_leaky_v2.launches == before + 1
    torch.testing.assert_close(states["v2"], states["plain"], rtol=0, atol=0)
    torch.testing.assert_close(states["v2"][2], state[2], rtol=0, atol=0)
    torch.testing.assert_close(vol.float(), p_vol.float(), rtol=0,
                               atol=2.0 ** -8)
    assert torch.equal(states["v2"], states["raw"]) and torch.equal(vol,
                                                                    r_vol)


@pytest.mark.parametrize("folded", [True, False], ids=["B4", "B7"])
def test_chain_kernels_match_twins(cuda, folded):
    stem = BinsFusionModuleFolded(16, 8)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in stem.named_parameters():
            p.normal_(0.1 if name.endswith("bias") else 0.0, 0.3,
                      generator=g)
    params = {k: v.to(cuda) for k, v in stem.chain_params().items()}
    vol = torch.rand(3, 8, 16, 64, generator=g).to(cuda, torch.bfloat16)
    if folded:
        fn, plain = bfm_chain_apply_folded, bfm_chain_apply_folded_plain
        args, kw = (vol.view(3, 8, 16 * 64), params), dict(width=16)
    else:
        fn, plain = bfm_chain_apply, bfm_chain_apply_plain
        args, kw = (vol, params), {}
    before = fn.launches
    out = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    if folded:
        pad = out.view(3, 8, 16, 64)[..., 48:]
        assert torch.equal(pad, torch.zeros_like(pad))


def test_wrappers_raise_on_misaligned_events(cuda):
    _, nv = _events(B=2, E=64)
    flat = torch.zeros(2 * 64 * 4 + 1, device=cuda)
    misaligned = flat[1:].view(2, 64, 4)
    with pytest.raises(ValueError, match="aligned"):
        scatter_cnt_tsum(misaligned, nv.to(cuda), height=SENSOR[0],
                         width=SENSOR[1])


def test_pipeline_on_card_matches_cpu(cuda):
    """The slice on the card (kernels, cuDNN, f32 without TF32) against the
    same slice on the CPU (plain twins), mini GEN1 geometry, 3 windows."""
    def make(device):
        model = build_detector(2, stem="bfm", in_channels=(32, 32, 32),
                               stem_out_channels=16, head_width=32)
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        return pipeline.make_pipeline_kernel(model, SENSOR, INPUT,
                                             device=device,
                                             dtype=torch.float32)
    runs = {d: make(d) for d in ("cpu", "cuda")}
    states = {d: pipeline.new_state(2, SENSOR, device=d) for d in runs}
    ev, nv = pipeline.synth_events(np.random.default_rng(0), 3, 2, 1024,
                                   SENSOR)
    for i in range(3):
        vols = {}
        for d, run in runs.items():
            states[d], vols[d] = run.stages["encode_transform"](
                states[d], torch.from_numpy(ev[i]).to(d),
                torch.from_numpy(nv[i]).to(d))
        torch.testing.assert_close(states["cuda"].cpu(), states["cpu"],
                                   rtol=0, atol=1e-2)
        torch.testing.assert_close(vols["cuda"].cpu().float(),
                                   vols["cpu"].float(), rtol=0, atol=2e-2)
        cpu_dets, cpu_keep = runs["cpu"].stages["detect"](vols["cpu"])
        gpu_dets, gpu_keep = runs["cuda"].stages["detect"](
            vols["cpu"].to(cuda))
        assert torch.isfinite(gpu_dets).all()
        torch.testing.assert_close(gpu_keep.cpu(), cpu_keep)
