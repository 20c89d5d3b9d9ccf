"""Port kernels on the card against their plain twins (marker `cuda`).

These tests need an NVIDIA GPU with nvcc and skip elsewhere. They import
no JAX, so on a machine without it they run with conftest.py left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: counts exact; t-sums within the f32 reordering bound
cnt^2 * 2^-23 (B8's atomics add in a run-dependent order; B1's contract
allows any order); B6's t-sums equal to the twin's bit for bit on the
steps' t - 1 (it sums them as integers at LSB 2^-24, the twin in f64, and
both round once), and two launches bitwise equal; the updates' state exact; volumes within one bf16 ulp (2^-8); B5
equal to B3 on the same planes, bit for bit; the BFM chain (B4, B7) within
atol 1e-2 + rtol 1e-2 (a bf16-rounded intermediate may round the other way
where the twin sums in another order), B4's pad channels exactly zero; the
int8 conv equal to its f64 twin bit for bit (integer sums, then the same
f32 dequant and bf16 rounding).
"""

from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch import pipeline, train
from frlw_evd_tpu_torch.encode import (
    scatter_cnt_tsum, scatter_cnt_tsum_pallas, scatter_cnt_tsum_pallas_plain,
    scatter_cnt_tsum_pallas_sorted, scatter_cnt_tsum_pallas_sorted_plain,
    scatter_cnt_tsum_plain, taf_update_leaky, taf_update_leaky_plain,
    taf_update_leaky_raw, taf_update_leaky_raw_plain, taf_update_leaky_v2,
    taf_update_leaky_v2_plain)
from frlw_evd_tpu_torch.encode.scatter import (MAX_SLOTS, event_cells,
                                               slot_chunks, tile_plan)
from frlw_evd_tpu_torch.models import build_detector, quantize
from frlw_evd_tpu_torch.models.quantize import int8_conv2d, int8_conv2d_plain
from frlw_evd_tpu_torch.models.stem_chain import (
    bfm_chain_apply, bfm_chain_apply_folded, bfm_chain_apply_folded_plain,
    bfm_chain_apply_plain)
from frlw_evd_tpu_torch.models.stems import BinsFusionModuleFolded
from frlw_evd_tpu_torch.train import adam

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

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


def _poison(*shapes):
    """Fill blocks of the outputs' sizes with NaN (-7 for int32) and free
    them, so the caching allocator hands them to the next call: an output
    cell the kernel leaves unwritten then shows. Returns their addresses."""
    blocks = [torch.full(shape, float("nan") if dtype == torch.float32
                         else -7, dtype=dtype, device="cuda")
              for shape, dtype in shapes]
    torch.cuda.synchronize()
    return {t.data_ptr() for t in blocks}


@pytest.mark.parametrize("sensor,E", [((62, 74), 3001), ((256, 480), 4096)],
                         ids=["one-cluster-ragged", "two-clusters"])
@pytest.mark.parametrize("layout", ["folded", "p64"])
def test_scatter_kernel_tiles_one_cell_and_writes_every_cell(cuda, sensor, E,
                                                             layout):
    """B1 where the cells are not a multiple of a cluster's range (62x74)
    or take two clusters (256x480), on 3 streams (less than a wave), E not
    a multiple of a warp: stream 0 skewed, stream 1 every event in one pixel
    and polarity, stream 2 empty (any_ev 0). The outputs land in blocks
    poisoned with NaN, so a cell left unwritten would show."""
    H, W = sensor
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(2), 1, 3, E,
                                          sensor)
    ev, nv = ev[0], nv[0]
    ev[1, :, 0], ev[1, :, 1], ev[1, :, 3] = 7.0, 5.0, 1.0
    nv[1], nv[2] = E, 0
    ev, nv = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    P = H * W * 2
    poisoned = _poison(((3, P), torch.float32), ((3, P), torch.float32),
                       ((3,), torch.int32))
    cnt, tsum, anyv = scatter_cnt_tsum(ev, nv, height=H, width=W,
                                       layout=layout)
    torch.cuda.synchronize()
    assert {cnt.data_ptr(), tsum.data_ptr(), anyv.data_ptr()} <= poisoned
    p_cnt, p_tsum, p_any = scatter_cnt_tsum_plain(ev, nv, height=H, width=W,
                                                  layout=layout)
    assert torch.isfinite(cnt).all() and torch.isfinite(tsum).all()
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert anyv.tolist() == p_any.tolist() == [1, 1, 0]
    assert int(cnt[1].max()) == E
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
    """B6 against its twin, a one-cell stream included: counts exact,
    t-sums bit for bit (the steps' t - 1), and two launches bitwise equal."""
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
    assert torch.equal(tsum, p_tsum)
    assert int(p_cnt[3].max()) == int(valid[3].sum())


@pytest.mark.parametrize("size", [45_001, 1_000_003],
                         ids=["one-cluster-ragged", "five-clusters"])
def test_exact_scatter_tiles_poison_and_no_sort(cuda, monkeypatch, size):
    """B6 on 3 streams (less than a wave), E = 4099, a size that is not a
    multiple of a cluster's range or that takes 5 clusters; stream 1 all in
    one cell. t are multiples of 2^-24 in [-1, 0], as the steps' t - 1, so
    the t-sums equal the twin's bit for bit; the outputs land in blocks
    poisoned with NaN; and the CUDA branch runs with torch.sort,
    torch.gather and torch.zeros made to raise. Then the range guard: at
    E = 4099 an addend with |t| >= 2^(21 - 13) turns its cell's t-sum NaN
    (so does a NaN t) and leaves every count and every other cell exact."""
    rng = np.random.default_rng(5)
    B, E = 3, 4099
    idx = rng.integers(-3, size + 3, (B, E)).astype(np.int32)
    idx[1] = 77
    tv = (-rng.integers(0, 2 ** 24 + 1, (B, E)) * 2.0 ** -24).astype(
        np.float32)
    valid = rng.random((B, E)) < 0.9
    idx, tv, valid = (torch.from_numpy(a).to(cuda) for a in (idx, tv, valid))
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_sorted_plain(idx, tv, valid, size)

    def refuse(name):
        def raise_(*args, **kwargs):
            raise AssertionError(f"the CUDA branch called torch.{name}")
        return raise_
    poisoned = _poison(((B, size), torch.float32), ((B, size), torch.float32))
    with monkeypatch.context() as m:
        for name in ("sort", "gather", "zeros"):
            m.setattr(torch, name, refuse(name))
        cnt, tsum = scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
        torch.cuda.synchronize()
    assert {cnt.data_ptr(), tsum.data_ptr()} <= poisoned
    assert torch.equal(cnt, p_cnt) and torch.equal(tsum, p_tsum)
    assert int(cnt[1, 77]) == int(valid[1].sum())

    ok = valid & (idx >= 0) & (idx < size)
    hit = ok.nonzero()[:2].tolist()          # two counted slots of stream 0
    bad = tv.clone()
    bad[tuple(hit[0])] = 2.0 ** 8
    bad[tuple(hit[1])] = float("nan")
    b_cnt, b_tsum = scatter_cnt_tsum_pallas_sorted(idx, bad, valid, size)
    torch.cuda.synchronize()
    assert torch.equal(b_cnt, p_cnt)
    nan_cells = {(b, int(idx[b, e])) for b, e in hit}
    assert {tuple(c) for c in b_tsum.isnan().nonzero().tolist()} == nan_cells
    keep = ~b_tsum.isnan()
    assert torch.equal(b_tsum[keep], p_tsum[keep])
    near = tv.clone()
    near[tuple(hit[0])] = 2.0 ** 8 - 1.0     # inside the range: summed
    n_cnt, n_tsum = scatter_cnt_tsum_pallas_sorted(idx, near, valid, size)
    w_cnt, w_tsum = scatter_cnt_tsum_pallas_sorted_plain(idx, near, valid,
                                                         size)
    assert torch.equal(n_cnt, w_cnt) and torch.equal(n_tsum, w_tsum)


def test_dense_scatter_matches_twin(cuda):
    """B8 against its twin on the folded cells, with 5 cells past the
    sensor's, so that the size is not a multiple of a cluster's range (a
    ragged last block)."""
    idx, tv, valid, size = _cells(cuda, "folded")
    size += 5
    before = scatter_cnt_tsum_pallas.launches
    cnt, tsum = scatter_cnt_tsum_pallas(idx, tv, valid, size)
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_plain(idx, tv, valid, size)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum_pallas.launches == before + 1
    plan = tile_plan(size)
    assert size % (plan.cluster * plan.cells)
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert ((tsum - p_tsum).abs() <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()


@pytest.mark.parametrize("kind", ["uniform", "one_cell", "striped",
                                  "large_t"])
@pytest.mark.parametrize("size", [45_001, 1_000_003],
                         ids=["one-cluster-ragged", "five-clusters"])
def test_dense_scatter_sets_and_every_cell(cuda, size, kind):
    """B8 on 3 streams, E = 4099: uniform cells; every slot of stream 1 in
    one cell; striped (slot e in cell e % 97, so each warp's lanes collide
    in pairs and threes); and t = +-1e6 and other |t| >> 1 in
    [-2^20, 2^20], which B1 and B6 would poison and B8 sums. Counts exact,
    t-sums within cnt^2 * 2^-23 * max|t| (f32 adds in a run-dependent
    order), no NaN, every cell written (poisoned outputs)."""
    rng = np.random.default_rng(6)
    B, E = 3, 4099
    idx = rng.integers(-3, size + 3, (B, E)).astype(np.int32)
    tv = rng.uniform(-1, 1, (B, E)).astype(np.float32)
    if kind == "one_cell":
        idx[1] = 77
    elif kind == "striped":
        idx[:] = np.arange(E) % 97
    elif kind == "large_t":
        tv = (rng.uniform(-1, 1, (B, E)) * 2.0 ** 20).astype(np.float32)
        tv[:, ::7] = 1e6
        tv[:, 3::7] = -1e6
    valid = rng.random((B, E)) < 0.9
    idx, tv, valid = (torch.from_numpy(a).to(cuda) for a in (idx, tv, valid))
    poisoned = _poison(((B, size), torch.float32), ((B, size), torch.float32))
    cnt, tsum = scatter_cnt_tsum_pallas(idx, tv, valid, size)
    torch.cuda.synchronize()
    assert {cnt.data_ptr(), tsum.data_ptr()} <= poisoned
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_plain(idx, tv, valid, size)
    assert torch.isfinite(cnt).all() and torch.isfinite(tsum).all()
    assert torch.equal(cnt, p_cnt)
    t_max = max(tv.abs().max().item(), 1.0)
    assert ((tsum - p_tsum).abs()
            <= p_cnt * p_cnt * 2.0 ** -23 * t_max + 1e-6).all()
    if kind == "one_cell":
        assert int(cnt[1, 77]) == int(valid[1].sum())


INT8_SHAPES = [  # (k, stride, Cin, Cout, H, W): AED site shapes, ragged ones
    (3, 2, 64, 128, 64, 80), (3, 1, 256, 256, 8, 10), (1, 1, 512, 128, 16, 20),
    (1, 1, 128, 64, 32, 40), (3, 2, 256, 256, 15, 21), (3, 1, 64, 40, 9, 7),
    (1, 1, 96, 8, 5, 3),
    # 128-pixel tiles (tile_plan: two waves or more) at BN = 256, and with a
    # K (864) that ends inside a stage, odd H and W
    (1, 1, 128, 256, 128, 96), (3, 1, 96, 128, 97, 129),
    # fewer pixels than one 64-pixel tile; BN = 32 for Cout 24
    (3, 2, 32, 24, 6, 5),
    # the halo kernel (3x3, Cin % 64 == 0): odd sizes, BN = 64 for Cout 40,
    # three 128-channel blocks at BN = 16, 64-channel blocks, stride 2
    (3, 1, 128, 40, 9, 7), (3, 1, 128, 256, 33, 41), (3, 1, 384, 16, 5, 6),
    (3, 1, 192, 128, 12, 15), (3, 2, 192, 40, 13, 11)]


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("k,stride,cin,cout,h,w", INT8_SHAPES)
def test_int8_conv_matches_twin_bit_for_bit(cuda, k, stride, cin, cout, h, w,
                                            bias):
    """int8_conv2d against its f64 twin on 3 images: int32 sums equal, bf16
    outputs equal bit for bit (an integer sum, then the same f32 multiply,
    add and bf16 rounding), inputs past the scale clipped, NCHW and
    channels_last inputs alike; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(k * 1000 + cin + cout)
    x = (2.0 * torch.randn(3, cin, h, w, device=cuda, generator=g)).to(
        torch.bfloat16)
    wq = torch.randint(-127, 128, (cout, k, k, cin), device=cuda,
                       generator=g, dtype=torch.int8)
    scale = torch.rand(cout, device=cuda, generator=g) * 1e-2
    b = torch.randn(cout, device=cuda, generator=g) if bias else None
    inv = 127.0 / 5.0
    before = int8_conv2d.launches
    for layout in (torch.contiguous_format, torch.channels_last):
        xx = x.contiguous(memory_format=layout)
        out, acc = int8_conv2d(xx, wq, scale, inv, b, stride=stride,
                               return_acc=True)
        p_out, p_acc = int8_conv2d_plain(xx, wq, scale, inv, b,
                                         stride=stride, return_acc=True)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == p_out.shape
        assert torch.equal(acc, p_acc)
        assert torch.equal(out, p_out)
    assert int8_conv2d.launches == before + 2
    assert (acc.abs() > 0).any()


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("k,stride,cin,cout,h,w", INT8_SHAPES)
def test_int8_site_matches_twin_bit_for_bit(cuda, k, stride, cin, cout, h,
                                            w, bias):
    """An Int8Site (the path's launch: its weight map encoded once, its
    dequant scale sw * sx) against the twin at its own codes, scale and
    inv: bf16 outputs equal bit for bit, on two calls of one map; one
    launch a call."""
    g = torch.Generator(device=cuda).manual_seed(k * 1000 + cin + cout + 7)
    q = torch.randint(-127, 128, (cout, cin, k, k), device=cuda,
                      generator=g, dtype=torch.int8)
    sw = torch.rand(cout, device=cuda, generator=g) * 1e-2
    b = (torch.randn(cout, device=cuda, generator=g) if bias else None)
    site = quantize.Int8Site(q, sw, 5.0 / 127.0, stride, b)
    before = int8_conv2d.launches
    for seed in range(2):
        x = (2.0 * torch.randn(3, cin, h, w, device=cuda, generator=g)).to(
            torch.bfloat16)
        out = site(x)
        p_out = int8_conv2d_plain(x, site.wq, site.scale, site.inv,
                                  site.bias, stride=stride)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == p_out.shape
        assert torch.equal(out, p_out)
    assert int8_conv2d.launches == before + 2
    assert (out.abs() > 0).any()


@pytest.mark.parametrize("k,stride,cin,cout,h,w", [
    s for s in INT8_SHAPES if min(s[2:4]) >= quantize.MIN_CHANNELS] + [
    # the 64x96 AED's smallest maps (a learnability -int8_eval site)
    (3, 1, 64, 64, 2, 3), (3, 2, 128, 128, 4, 6)])
def test_int8_site_on_f32_activation(cuda, k, stride, cin, cout, h, w):
    """An f32 network's site on the card: a bare Int8Site (as int8_conv2d)
    refuses an f32 activation; int8_ctx with act_dtype bf16 (the f32 eval
    step's sites) launches once a call and equals int8_conv2d_plain on the
    bf16-rounded input, cast back to f32, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(k * 1000 + cin + cout + 11)
    conv = torch.nn.Conv2d(cin, cout, k, stride, (k - 1) // 2).to(cuda)
    x = 2.0 * torch.randn(3, cin, h, w, device=cuda, generator=g)
    ctx = quantize.int8_ctx(torch.nn.Sequential(conv), {"0": 3.0 / 127.0},
                            act_dtype=torch.bfloat16)
    (_, site), = ctx.sites.values()
    with pytest.raises(ValueError, match="bf16"):
        site(x)
    before = int8_conv2d.launches
    with torch.no_grad(), ctx:
        out = conv(x)
    want = int8_conv2d_plain(x.to(torch.bfloat16), site.wq, site.scale,
                             site.inv, site.bias, stride=stride).float()
    torch.cuda.synchronize()
    assert int8_conv2d.launches == before + 1
    assert out.dtype == torch.float32 and torch.equal(out, want)
    assert (out.abs() > 0).any()


@pytest.mark.parametrize("width,h,w", [(256, 32, 40), (64, 9, 7)])
def test_merged_int8_sites_match_twin_bit_for_bit(cuda, width, h, w):
    """The merged head's int8 sites (quantize.MergedSites): layer 0 one
    site of Cout 2W on the shared input, layer 1 one site a group on its
    own channel half (a strided slice of the channels_last input, copied
    to a contiguous one before the launch); each launch bit for bit its
    twin, the hook's output their concatenation; three launches a level's
    towers."""
    from frlw_evd_tpu_torch.models.heads import YOLOXHead
    head = YOLOXHead(2, (width,), strides=(8,), width=width,
                     merged=True).to(cuda).eval()
    keys = [key for layer in (0, 1)
            for key in quantize.tower_keys("head", 0, layer)]
    scales = dict(zip(keys, (3.0 / 127, 5.0 / 127, 2.0 / 127, 4.0 / 127)))
    sites = quantize.MergedSites("head", head, scales, {})
    assert sites.sites[0, 0][0].wq.shape[0] == 2 * width
    g = torch.Generator(device=cuda).manual_seed(width + h)
    before = int8_conv2d.launches
    for layer, cin in ((0, width), (1, 2 * width)):
        x = (2.0 * torch.randn(3, cin, h, w, device=cuda, generator=g)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        out = sites(0, layer, x)
        parts = quantize.merged_parts(x, layer)[:len(sites.sites[0, layer])]
        want = torch.cat([int8_conv2d_plain(p, s.wq, s.scale, s.inv)
                          for s, p in zip(sites.sites[0, layer], parts)],
                         dim=1)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and out.shape == (3, 2 * width,
                                                             h, w)
        assert torch.equal(out, want), layer
        assert (out.abs() > 0).any()
    assert int8_conv2d.launches == before + 3


def test_int8_conv_wrapper_raises(cuda):
    """Cin % 32 != 0, Cout % 8 != 0, k = 5, an f32 activation on the card
    and a CPU/CUDA mix raise; nothing launches."""
    x = torch.zeros(1, 64, 8, 8, device=cuda, dtype=torch.bfloat16)
    wq = torch.zeros(64, 3, 3, 64, device=cuda, dtype=torch.int8)
    scale = torch.ones(64, device=cuda)
    before = int8_conv2d.launches
    with pytest.raises(ValueError, match="Cin % 32"):
        int8_conv2d(torch.zeros(1, 80, 8, 8, device=cuda,
                                dtype=torch.bfloat16),
                    torch.zeros(64, 3, 3, 80, device=cuda, dtype=torch.int8),
                    scale, 1.0)
    with pytest.raises(ValueError, match="Cout % 8"):
        int8_conv2d(x, wq[:60], scale[:60], 1.0)
    with pytest.raises(ValueError, match="k in"):
        int8_conv2d(x, torch.zeros(64, 5, 5, 64, device=cuda,
                                   dtype=torch.int8), scale, 1.0)
    with pytest.raises(ValueError, match="bf16"):
        int8_conv2d(x.float(), wq, scale, 1.0)
    for args in ((x.cpu(), wq, scale), (x, wq.cpu(), scale),
                 (x, wq, scale.cpu())):
        with pytest.raises(ValueError, match="on c"):
            int8_conv2d(*args, 1.0)
    assert int8_conv2d.launches == before


def test_int8_path_on_card_matches_cpu(cuda, monkeypatch):
    """The int8 GEN1 slice at a small size: calibrate_pipeline on the card
    (bf16) and on the CPU (f32) find the same sites, scales within 5e-2
    (bf16 against f32 activations); with the CPU's (scales, table) in
    both, every site launches once a forward on the card, the card's int8
    maps are within relative L2 0.08 of its bf16 maps (the serving form's
    gate, tests/test_quantize.py:132), and within 0.08 of the same bf16
    model's int8 maps on the CPU through the twins of the card's kernels
    (the int8 conv's, and the fused epilogue's `bn_act_plain` on a
    channels_last CPU model; the frameworks' bf16 convs and the codes
    they feed round apart). The CPU's separate BatchNorm, activation and
    add passes round two or three times a site where the card rounds
    once, and the int8 codes flip on those roundings (0.088 from the
    card's maps at level 1, on an H100): the card's maps are held to the
    same model's f32 maps on the CPU instead, each level within 0.08,
    and no farther from them than the separate passes' int8 maps."""
    sensor, inp = (60, 72), (64, 96)
    ev, nv = pipeline.synth_events(np.random.default_rng(0), 3, 2, 1024,
                                   sensor)

    def make(device, dtype):
        model = build_detector(2, stem="bfm", in_channels=(64, 64, 64),
                               stem_out_channels=64, head_width=64)
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        f32_state = {k: v.clone() for k, v in model.state_dict().items()}
        base = pipeline.make_pipeline_kernel(model, sensor, inp,
                                             device=device, dtype=dtype)
        state = pipeline.new_state(2, sensor, device=device)
        windows = [(torch.from_numpy(ev[i]).to(device),
                    torch.from_numpy(nv[i]).to(device)) for i in range(3)]
        quant = pipeline.calibrate_pipeline(base, model, f32_state, state,
                                            windows[:2])
        _, vol = base.stages["encode_transform"](state, *windows[2])
        return model, quant, vol

    def maps(model, vol, quant=None):
        with torch.inference_mode():
            if quant is None:
                return [o.double().cpu() for o in model(vol)]
            with quantize.int8_ctx(model, *quant):
                return [o.double().cpu() for o in model(vol)]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    g_model, g_quant, g_vol = make("cuda", torch.bfloat16)
    c_model, c_quant, _ = make("cpu", torch.float32)
    assert set(g_quant[0]) == set(c_quant[0])
    assert len(g_quant[0]) > 20
    for key, sx in c_quant[0].items():
        assert abs(g_quant[0][key] / sx - 1) < 5e-2, key
    before = int8_conv2d.launches
    g_int8 = maps(g_model, g_vol, c_quant)
    assert int8_conv2d.launches == before + len(c_quant[0])
    g_bf16 = maps(g_model, g_vol)
    c_f32 = maps(c_model, g_vol.cpu().float())
    c_model.to(torch.bfloat16)
    c_int8 = maps(c_model, g_vol.cpu(), c_quant)
    from frlw_evd_tpu_torch.models import epilogue
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "cpu")
    pipeline.channels_last_(c_model)
    c_twins = maps(c_model, g_vol.cpu(), c_quant)
    for lvl, (q, b, t, f) in enumerate(zip(g_int8, g_bf16, c_twins, c_f32)):
        assert 0 < rel(q, b) < 0.08, (lvl, rel(q, b))
        assert rel(q, t) < 0.08, (lvl, rel(q, t))
        assert rel(q, f) < 0.08, (lvl, rel(q, f))

    def flat(ms):
        return torch.cat([m.flatten() for m in ms])

    assert rel(flat(g_int8), flat(c_f32)) <= rel(flat(c_int8), flat(c_f32))


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


@pytest.mark.parametrize("shape", [(3, 8, 16), (3, 5, 7)],
                         ids=["aligned", "ragged"])
@pytest.mark.parametrize("folded", [True, False], ids=["B4", "B7"])
def test_chain_kernels_match_twins(cuda, folded, shape, monkeypatch):
    """B4 and B7 against their twins; the ragged shape has B*H2*W2 = 105
    pixels, so the last 4-pixel tile is cut. The output is allocated filled
    with NaN, so a word the kernel leaves unwritten (B4's pad included)
    shows."""
    B, H2, W2 = shape
    stem = BinsFusionModuleFolded(16, 8)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in stem.named_parameters():
            p.normal_(0.1 if name.endswith("bias") else 0.0, 0.3,
                      generator=g)
    params = {k: v.detach().to(cuda) for k, v in stem.chain_params().items()}
    vol = torch.rand(B, H2, W2, 64, generator=g).to(cuda, torch.bfloat16)
    if folded:
        fn, plain = bfm_chain_apply_folded, bfm_chain_apply_folded_plain
        args, kw = (vol.view(B, H2, W2 * 64), params), dict(width=W2)
        alloc = "empty_like"
    else:
        fn, plain = bfm_chain_apply, bfm_chain_apply_plain
        args, kw = (vol, params), {}
        alloc = "empty"
    make = getattr(torch, alloc)
    monkeypatch.setattr(torch, alloc, lambda *a, **k: make(*a, **k).fill_(
        float("nan")))
    before = fn.launches
    out = fn(*args, **kw)
    monkeypatch.undo()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == want.shape and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all()), "an output word was not written"
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    if folded:
        pad = out.view(B, H2, W2, 64)[..., 48:]
        assert torch.equal(pad, torch.zeros_like(pad))


@pytest.mark.parametrize("E", [2 ** 17, 2 ** 19])
def test_histograms_take_more_slots_than_a_count_holds(cuda, E):
    """A cell's count has 17 bits, so B1 and B6 launch once a chunk of at
    most MAX_SLOTS slots and add the chunks' planes: at E = 2^17 and 2^19
    on 3 streams (uniform, one cell, stopping inside the last chunk) they
    match their twins with the gates above (B1's counts and any_ev exact,
    t-sums within cnt^2 * 2^-23; B6 bit for bit) and launch once a chunk."""
    H, W = SENSOR
    ev, nv = pipeline.synth_events(np.random.default_rng(4), 1, 3, E, SENSOR)
    ev, nv = ev[0], nv[0]
    ev[1, :, 0], ev[1, :, 1], ev[1, :, 3] = 7.0, 5.0, 1.0
    nv[2] = E - 5
    ev, nv = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    chunks = len(slot_chunks(E))
    assert chunks == -(-E // MAX_SLOTS) > 1
    before = scatter_cnt_tsum.launches
    cnt, tsum, anyv = scatter_cnt_tsum(ev, nv, height=H, width=W)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum.launches == before + chunks
    p_cnt, p_tsum, p_any = scatter_cnt_tsum_plain(ev, nv, height=H, width=W)
    torch.testing.assert_close(cnt, p_cnt, rtol=0, atol=0)
    assert anyv.tolist() == p_any.tolist() == [1, 1, 1]
    assert int(cnt[1].max()) == E and int(cnt[2].sum()) == E - 5
    assert ((tsum - p_tsum).abs() <= p_cnt * p_cnt * 2.0 ** -23 + 1e-6).all()

    idx, tv, valid = event_cells(ev, nv, H, W)
    before = scatter_cnt_tsum_pallas_sorted.launches
    cnt6, tsum6 = scatter_cnt_tsum_pallas_sorted(idx, tv, valid, H * W * 2)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum_pallas_sorted.launches == before + chunks
    p_cnt6, p_tsum6 = scatter_cnt_tsum_pallas_sorted_plain(idx, tv, valid,
                                                           H * W * 2)
    assert torch.equal(cnt6, p_cnt6) and torch.equal(cnt6, p_cnt)
    assert torch.equal(tsum6.view(torch.int32), p_tsum6.view(torch.int32))


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


def test_train_step_on_card_matches_cpu(cuda):
    """chip_smoke.py's phase 19: in f32 (no TF32) the losses rtol 2e-4 and
    the running statistics atol 1e-5; with the network in f64 on both, each
    gradient leaf within 1e-6 of its largest magnitude and the parameters
    after the step atol 1e-6."""
    err = chip_smoke.small_train_errors(train, build_detector, cuda)
    for k, gate in chip_smoke.SMALL_TRAIN_GATES.items():
        assert err[k] <= gate, (k, err[k])


def test_folded_stem_sees_optimizer_updates(cuda):
    """The bfm_folded stem keeps its packed B4 weights while its parameter
    tensors' version counters stay put; an optimiser step in place bumps
    them, so after three Adam steps B4 runs on the new weights (its twin
    on the current parameters agrees, the chain's output moved)."""
    model = build_detector(2, stem="bfm_folded",
                           generator=torch.Generator().manual_seed(0),
                           in_channels=(16, 16, 16), stem_out_channels=8,
                           head_width=16).to(cuda)
    params = model.backbone.stem.chain_params()
    vol = torch.rand(2, 8, 12 * 64, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        first = bfm_chain_apply_folded(vol, params, width=12)
    versions = {k: p._version for k, p in params.items()}
    opt = adam(0.1).make(model.named_parameters())
    g = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, device=cuda, generator=g)
        opt.step()
    assert all(p._version > versions[k] for k, p in params.items())
    before = bfm_chain_apply_folded.launches
    with torch.no_grad():
        out = bfm_chain_apply_folded(vol, params, width=12)
        want = bfm_chain_apply_folded_plain(vol, params, width=12)
    torch.cuda.synchronize()
    assert bfm_chain_apply_folded.launches == before + 1
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert (out.float() - first.float()).abs().max() > 0.1


@pytest.mark.parametrize("precise", [True, False])
def test_mxu_histogram_launches_b6_and_matches_twin(cuda, precise):
    """scatter_cnt_tsum_mxu on the card: JAX's bf16 rounding of the
    addends, then one B6 launch; equal to the CPU route (B6's twin) bit for
    bit, since every rounded t - 1 is a multiple of 2^-24. A counted value
    outside B6's range raises."""
    from frlw_evd_tpu_torch.encode import scatter_cnt_tsum_mxu

    ev, nv = _events(B=4, E=4096, seed=3)
    idx, tv, valid = event_cells(ev, nv, *SENSOR)
    before = scatter_cnt_tsum_pallas_sorted.launches
    cnt, tsum = scatter_cnt_tsum_mxu(idx.to(cuda), tv.to(cuda),
                                     valid.to(cuda), SENSOR[0] * SENSOR[1]
                                     * 2, precise)
    torch.cuda.synchronize()
    assert scatter_cnt_tsum_pallas_sorted.launches == before + 1
    c_cnt, c_tsum = scatter_cnt_tsum_mxu(idx, tv, valid,
                                         SENSOR[0] * SENSOR[1] * 2, precise)
    assert torch.equal(cnt.cpu(), c_cnt) and torch.equal(tsum.cpu(), c_tsum)
    with pytest.raises(ValueError, match="B6"):
        scatter_cnt_tsum_mxu(idx.to(cuda), tv.to(cuda) * 1000.0,
                             valid.to(cuda), SENSOR[0] * SENSOR[1] * 2)


@pytest.mark.parametrize("scatter,precise", [("pallas", False),
                                             ("pallas", True),
                                             ("sorted", False)],
                         ids=["raw", "precise", "sorted"])
def test_p64_k4_step_launches_b2_and_matches_cpu(cuda, scatter, precise):
    """The p64 step at K = 4 on the card: B2 at (H/2, (W/2)*4) with
    2K = 8, one launch a window, three windows carrying state, state exact
    and volume within one bf16 ulp of the CPU step (the twins)."""
    from frlw_evd_tpu_torch.encode import (p64_init_state,
                                           taf_stream_step_kernel_p64)

    H, W = P64_SENSOR
    states = {d: p64_init_state(4, H, W, K=4, device=d)
              for d in ("cpu", cuda)}
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(2), 3, 4,
                                          4096, P64_SENSOR)
    before = taf_update_leaky.launches
    for i in range(3):
        vols = {}
        for d in states:
            states[d], vols[d] = taf_stream_step_kernel_p64(
                states[d], torch.from_numpy(ev[i]).to(d),
                torch.from_numpy(nv[i]).to(d), height=H, width=W,
                scatter=scatter, precise=precise)
        torch.cuda.synchronize()
        torch.testing.assert_close(states[cuda].cpu(), states["cpu"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(vols[cuda].cpu().float(),
                                   vols["cpu"].float(), rtol=0,
                                   atol=2.0 ** -8)
    assert taf_update_leaky.launches == before + 3


@pytest.mark.parametrize("scatter", ["pallas", "sorted"])
def test_folded_step_launches_b2_and_matches_cpu(cuda, scatter):
    """The folded TAF step of streaming.py on the card: its update is one
    B2 launch a window; three windows carrying state, state equal to the
    CPU step's (the twins) bit for bit."""
    from frlw_evd_tpu_torch.encode import init_state
    from frlw_evd_tpu_torch.encode.streaming import taf_stream_step_folded

    H, W = SENSOR
    states = {d: init_state(4, H, W, device=d) for d in ("cpu", cuda)}
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(4), 3, 4,
                                          4096, SENSOR)
    before = taf_update_leaky.launches
    for i in range(3):
        for d in states:
            taf_stream_step_folded(states[d], torch.from_numpy(ev[i]).to(d),
                                   torch.from_numpy(nv[i]).to(d), height=H,
                                   width=W, scatter=scatter)
        torch.cuda.synchronize()
        torch.testing.assert_close(states[cuda].cpu(), states["cpu"],
                                   rtol=0, atol=0)
    assert taf_update_leaky.launches == before + 3


def test_spans_on_card_time_the_stages_and_count_every_host_sync(cuda):
    """Under profiling.recording(), the GEN1 slice on the card: the stage
    and kernel spans carry device ms, the NMS loop's spans none, the
    forward, decode and post tile the detect span's device time, and
    torch.cuda's sync debug mode warns once for each counted host sync."""
    from frlw_evd_tpu_torch.utils import profiling
    model = build_detector(2, stem="bfm", in_channels=(32, 32, 32),
                           stem_out_channels=16, head_width=32)
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    run = pipeline.make_pipeline_kernel(model, SENSOR, INPUT, device=cuda,
                                        dtype=torch.float32)
    state = pipeline.new_state(2, SENSOR, device=cuda)
    ev, nv = pipeline.synth_events(np.random.default_rng(0), 3, 2, 1024,
                                   SENSOR)
    ev, nv = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    state, _ = run(state, ev[0], nv[0])        # build and load the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")     # its first call warns once
    profiling.clear_spans()
    warned = []
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording():
            warnings.simplefilter("always")
            for i in (1, 2):
                state, (dets, keep) = run(state, ev[i], nv[i])
            warned = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s = profiling.spans_summary()
    assert s["steps"] == 2
    assert s["counts"]["host_syncs"] == s["counts"]["nms_rounds"] \
        == len(warned) >= 2
    spans = s["spans"]
    for name in ("serve.encode", "kernel.b1", "kernel.b2", "serve.detect",
                 "serve.forward", "serve.decode", "serve.post",
                 "serve.select"):
        assert spans[name]["device_ms"] > 0, name
    assert spans["serve.nms_round"]["device_ms"] is None
    assert spans["host_sync"]["device_ms"] is None
    parts = sum(spans[n]["device_ms"] for n in ("serve.forward",
                                                "serve.decode", "serve.post"))
    assert parts == pytest.approx(spans["serve.detect"]["device_ms"],
                                  rel=0.02, abs=0.05)


# the conv blocks' fused epilogue (models/epilogue.py, csrc/bn_act.cu)

AED_FORMS = {"gen1": ("bfm", 2, (2, 256, 320, 16)),
             "gen4": ("bfm_folded", 7, (2, 256, 320 * 64))}


def _served_aed(cuda, form, dtype=torch.bfloat16, **widths):
    stem, classes, _ = AED_FORMS[form]
    torch.manual_seed(0)
    model = build_detector(classes, stem=stem, **widths)
    pipeline.spread_random_weights_(model, torch.Generator().manual_seed(1))
    pipeline._serving_model(model, cuda, dtype)
    return model


def _aed_volume(cuda, form, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(AED_FORMS[form][2], generator=g).to(cuda,
                                                          torch.bfloat16)


def _epilogue_blocks(model):
    """The model's conv blocks that end in conv_epilogue, in module order
    (the stem's first)."""
    from frlw_evd_tpu_torch.models.blocks import BaseConv
    from frlw_evd_tpu_torch.models.stems import _PadInBaseConv
    return [m for m in model.modules()
            if isinstance(m, (BaseConv, _PadInBaseConv))]


def _site_shapes(model, vol):
    """The distinct (C, H, W) of every conv epilogue's input in one
    forward (forward hooks on the blocks' conv submodules)."""
    shapes, hooks = set(), []
    for m in _epilogue_blocks(model):
        hooks.append(m.conv.register_forward_hook(
            lambda mod, args, out: shapes.add(tuple(out.shape[1:]))))
    try:
        with torch.inference_mode():
            model(vol)
    finally:
        for h in hooks:
            h.remove()
    return sorted(shapes)


def _epilogue_counts(fn):
    from frlw_evd_tpu_torch.utils import profiling
    profiling.clear_spans()
    with profiling.recording(), profiling.span("f"):
        out = fn()
    counts = profiling.spans_summary()["counts"]
    profiling.clear_spans()
    return out, counts


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("form", sorted(AED_FORMS))
def test_bn_act_kernel_matches_twin_at_every_aed_site(cuda, form):
    """Every site shape of the AED at the cells' inputs (B = 2), silu with
    and without a residual in bf16 parameters, relu and lrelu in f32
    ones: the kernel within one bf16 ulp of its twin (run on the card),
    each launch counted."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_bn_act import assert_within_ulps
    from frlw_evd_tpu_torch.models.epilogue import bn_act, bn_act_plain
    shapes = _site_shapes(_served_aed(cuda, form), _aed_volume(cuda, form))
    assert len(shapes) >= 8
    g = torch.Generator().manual_seed(3)
    for C, H, W in shapes:
        x, r = (torch.randn(2, C, H, W, generator=g).mul(3).to(
            cuda, torch.bfloat16).contiguous(
                memory_format=torch.channels_last) for _ in range(2))
        base = [torch.randn(C, generator=g), torch.rand(C, generator=g) + .05,
                torch.randn(C, generator=g), torch.randn(C, generator=g)]
        for act, res, dtype in (("silu", False, torch.bfloat16),
                                ("silu", True, torch.bfloat16),
                                ("relu", True, torch.float32),
                                ("lrelu", False, torch.float32)):
            params = [p.to(cuda, dtype) for p in base]
            residual = r if res else None
            before = bn_act.launches
            got = bn_act(x, *params, 1e-5, act, residual)
            assert bn_act.launches == before + 1
            assert got.stride() == x.stride()
            want = bn_act_plain(x, *params, 1e-5, act, residual)
            assert_within_ulps(got.cpu(), want.cpu(), x.cpu(),
                               *[p.cpu() for p in params], 1e-5,
                               None if residual is None else residual.cpu())


def test_fused_aed_forward_matches_the_old_path(cuda, monkeypatch):
    """An aed_gen4-shaped forward (bfm_folded stem, 512x640, full widths)
    at B = 2: 62 fused launches and no plain site; the separate passes
    (KERNEL_DEVICE moved off the card) count 62 plain sites. Both are bf16
    forwards that round apart, by about what bf16 costs against f32 (the
    benchmark's head_gap, 0.02): the fused head maps lie within relative
    L2 0.05 of the separate passes' and no farther from the same model's
    f32 maps (TF32 off) than theirs, within 2%, having one rounding a
    site where they have two or three. On an H100 the sound forward read
    0.0177 (0.0145-0.0205 a level); the gate holds against a planted
    fault, the stem site's BatchNorm parameters of channels 0-7 and 8-15
    swapped (as a kernel that misreads its channel groups would apply
    them), which read 0.103."""
    from frlw_evd_tpu_torch.models import epilogue
    model = _served_aed(cuda, "gen4")
    vol = _aed_volume(cuda, "gen4")
    before = epilogue.bn_act.launches
    with torch.inference_mode():
        fused, counts = _epilogue_counts(lambda: model(vol))
    assert counts == {"epilogue_fused": 62}
    assert epilogue.bn_act.launches == before + 62
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "none")
    with torch.inference_mode():
        plain, counts = _epilogue_counts(lambda: model(vol))
        ref = _served_aed(cuda, "gen4", torch.float32)(vol.float())
    assert counts == {"epilogue_plain": 62}

    def flat(maps):
        return torch.cat([m.double().flatten() for m in maps])

    assert _rel(flat(fused), flat(plain)) < 0.05
    assert _rel(flat(fused), flat(ref)) <= 1.02 * _rel(flat(plain), flat(ref))
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "cuda")
    bn = _epilogue_blocks(model)[0].bn
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
            t[:16] = torch.cat([t[8:16], t[:8]])
    with torch.inference_mode():
        faulty = model(vol)
    assert _rel(flat(faulty), flat(plain)) > 0.05


def test_fused_yolov3_forward_matches_the_old_path(cuda, monkeypatch):
    """yolov3's ConvBnLeaky blocks (a conv bias, BatchNorm, leaky relu
    0.1) at eval in bf16 on the card, 256x320 at B = 2: all 72 fused,
    none plain; the separate passes count 72 plain. The fused head maps
    lie within relative L2 1e-2 of the separate passes' (0.0071 on an
    H100: the ResBlocks' adds stay outside the epilogue) and no farther
    from the same model's f32 maps (TF32 off) than theirs, within 2%."""
    from frlw_evd_tpu_torch.models import epilogue
    from frlw_evd_tpu_torch.models.yolov3 import YOLOv3Detector

    def served(dtype):
        torch.manual_seed(0)
        model = YOLOv3Detector(2, 16)
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        pipeline._serving_model(model, cuda, dtype)
        return model

    model = served(torch.bfloat16)
    assert len(_epilogue_blocks(model)) == 72
    vol = torch.rand((2, 256, 320, 16), generator=torch.Generator(
    ).manual_seed(0)).to(cuda, torch.bfloat16)
    before = epilogue.bn_act.launches
    with torch.inference_mode():
        fused, counts = _epilogue_counts(lambda: model(vol))
    assert counts == {"epilogue_fused": 72}
    assert epilogue.bn_act.launches == before + 72
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "none")
    with torch.inference_mode():
        plain, counts = _epilogue_counts(lambda: model(vol))
        ref = served(torch.float32)(vol.float())
    assert counts == {"epilogue_plain": 72}

    def flat(maps):
        return torch.cat([m.double().flatten() for m in maps])

    assert _rel(flat(fused), flat(plain)) < 1e-2
    assert _rel(flat(fused), flat(ref)) <= 1.02 * _rel(flat(plain), flat(ref))


def test_int8_sites_feed_the_fused_epilogue(cuda, monkeypatch):
    """Under int8_ctx every calibrated site's conv is the int8 kernel and
    its epilogue the fused one: 62 fused, the int8 launches counted. A
    bf16 rounding apart moves the next site's int8 codes, so the fused
    and the separate passes' int8 maps differ by what int8 costs; each is
    held to the same model's f32 maps on the card (TF32 off): the fused
    one within relative L2 0.08 (the int8 serving gate) and no farther
    than the separate passes', within 5%."""
    from frlw_evd_tpu_torch.models import epilogue
    sensor, inp = (60, 72), (64, 96)
    ev, nv = pipeline.synth_events(np.random.default_rng(0), 3, 2, 1024,
                                   sensor)

    def make(dtype):
        model = build_detector(2, stem="bfm", in_channels=(64, 64, 64),
                               stem_out_channels=64, head_width=64)
        pipeline.spread_random_weights_(model,
                                        torch.Generator().manual_seed(1))
        f32_state = {k: v.clone() for k, v in model.state_dict().items()}
        run = pipeline.make_pipeline_kernel(model, sensor, inp, device=cuda,
                                            dtype=dtype)
        return model, f32_state, run

    model, f32_state, run = make(torch.bfloat16)
    state = pipeline.new_state(2, sensor, device=cuda)
    windows = [(torch.from_numpy(ev[i]).to(cuda),
                torch.from_numpy(nv[i]).to(cuda)) for i in range(3)]
    quant = pipeline.calibrate_pipeline(run, model, f32_state, state,
                                        windows[:2])
    _, vol = run.stages["encode_transform"](state, *windows[2])
    with torch.inference_mode():
        ref = make(torch.float32)[0](vol.float())

    def flat(maps):
        return torch.cat([m.double().flatten() for m in maps])

    gaps = {}
    for device, kind in (("cuda", "epilogue_fused"),
                         ("none", "epilogue_plain")):
        monkeypatch.setattr(epilogue, "KERNEL_DEVICE", device)
        before = int8_conv2d.launches
        with torch.inference_mode(), quantize.int8_ctx(model, *quant):
            q, counts = _epilogue_counts(lambda: model(vol))
        assert int8_conv2d.launches == before + len(quant[0]) > 20
        assert counts == {kind: 62}
        gaps[device] = _rel(flat(q), flat(ref))
    assert gaps["cuda"] < 0.08, gaps
    assert gaps["cuda"] <= 1.05 * gaps["none"], gaps


def test_export_of_a_served_model_calls_the_epilogue_operator(cuda,
                                                              tmp_path):
    """torch.export of the served GEN1 step on the card (tools/
    export_model, 64x96, 32 wide): every site is one
    frlw_evd_torch::bn_act call, and the saved and loaded program gives
    the live step's boxes (keep equal, dets within 1e-5, the tool's
    check)."""
    from frlw_evd_tpu_torch.models import epilogue
    from frlw_evd_tpu_torch.tools import export_model as ex
    cfg = ex.config(img_hw=(64, 96), small=True)
    step, shape, _ = ex.build_serving_fn(cfg, ex.build_model(cfg), 2,
                                         device=cuda)
    program = ex.export(step, shape, cuda)
    calls = [n for n in program.graph.nodes if n.op == "call_function"
             and "bn_act" in str(n.target)]
    assert len(calls) == 62
    path = str(tmp_path / "step.pt2")
    torch.export.save(program, path)
    vol = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(
        cuda)
    before = epilogue.bn_act.launches
    with torch.no_grad():
        live_dets, live_keep = ex.ServingStep(step.model, step.strides,
                                              "rounds")(vol)
        got_dets, got_keep = torch.export.load(path).module()(vol)
    assert epilogue.bn_act.launches == before + 2 * 62
    assert torch.equal(live_keep, got_keep)
    assert (live_dets - got_dets).abs().max().item() <= 1e-5


def _served_red(cuda, dtype=torch.bfloat16):
    """RED as the red_gen4 cell builds it, BatchNorm statistics and affines
    spread away from the identity, served in `dtype` (channels_last)."""
    from frlw_evd_tpu_torch.models.detector import (RED_IN_CHANNELS,
                                                    RED_STRIDES)
    torch.manual_seed(0)
    model = build_detector(7, family="red", input_channels=16,
                           in_channels=RED_IN_CHANNELS, strides=RED_STRIDES)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(1.0, 2.0, generator=g)
                m.bias.normal_(0.0, 0.5, generator=g)
    pipeline._serving_model(model, cuda, dtype)
    return model


def test_bn_act_kernel_matches_twin_at_every_red_site(cuda):
    """RED's 13 sites at the red_gen4 cell's input (chip_smoke's census of
    one forward): the stem's and each block's c1 and c2 with relu, c3
    linear, `down` linear with a residual gated per sample and channel; at
    B = 2 with bf16 parameters, and each gated site also at B = 3 with f32
    ones, where a block's pixels straddle two samples (the gate's row
    changes inside a block).
    The kernel within one bf16 ulp of its twin (run on the card), plus
    2^-20 of the f32 terms' magnitude |x * scale| + |mean * scale| +
    |bias| + |residual| (chip_smoke.bf16_ulps_over, phase 47's tolerance:
    the kernel folds shift = bias - mean * scale, the twin subtracts mean
    from x first, so where bias and mean * scale cancel, |shift|
    understates what the two f32 orders round), each launch counted."""
    from frlw_evd_tpu_torch.models.epilogue import bn_act, bn_act_plain
    sites = chip_smoke.red_epilogue_sites(pipeline, cuda)
    blocks = ((64, 256, 320, 128, 160), (64, 128, 160, 64, 80),
              (128, 64, 80, 32, 40))
    want = {("relu", False, 32, 256, 320): 1}
    for C, H1, W1, H2, W2 in blocks:
        for key in (("relu", False, C, H1, W1), ("relu", False, C, H2, W2),
                    ("linear", False, C, H2, W2), ("linear", True, C, H2,
                                                   W2)):
            want[key] = want.get(key, 0) + 1
    assert sites == want
    cases = [(a, gt, (C, H, W), 2, torch.bfloat16)
             for a, gt, C, H, W in sites]
    cases += [(a, gt, (C, H, W), 3, torch.float32)
              for a, gt, C, H, W in sites if gt]
    g = torch.Generator().manual_seed(5)
    for act, gated, (C, H, W), N, dtype in cases:
        x, r = (torch.randn(N, C, H, W, generator=g).mul(3).to(
            cuda, torch.bfloat16).contiguous(
                memory_format=torch.channels_last) for _ in range(2))
        gate = torch.sigmoid(torch.randn(N, C, 1, 1, generator=g) * 2).to(
            cuda, torch.bfloat16) if gated else None
        params = [p.to(cuda, dtype) for p in (
            torch.randn(C, generator=g), torch.rand(C, generator=g) + .05,
            torch.randn(C, generator=g), torch.randn(C, generator=g))]
        residual = r if gated else None
        before = bn_act.launches
        got = bn_act(x, *params, 1e-5, act, residual, gate)
        assert bn_act.launches == before + 1
        assert got.stride() == x.stride()
        want = bn_act_plain(x, *params, 1e-5, act, residual, gate)
        over, _ = chip_smoke.bf16_ulps_over(got, want, x, params, 1e-5,
                                            residual)
        assert over <= 0, (act, gated, (N, C, H, W), dtype, over)


def test_fused_red_forward_counts_13_sites(cuda, monkeypatch):
    """A served red_gen4 forward (512x640, full widths, bf16 backbone, f32
    memory) at B = 2: 13 fused launches and no plain site; the separate
    passes (KERNEL_DEVICE moved off the card) count 13 plain. The fused
    head outputs and carries lie within relative L2 0.05 of the separate
    passes' and no farther from the same model's f32 outputs (TF32 off)
    than theirs, within 2%, having one rounding a site where they have two
    to four."""
    from frlw_evd_tpu_torch.models import epilogue
    model = _served_red(cuda)
    x = torch.rand((2, 512, 640, 16), generator=torch.Generator(
    ).manual_seed(0)).to(cuda)
    carries = model.init_carries(2, 512, 640, device=cuda)

    def flat(out):
        new_carries, maps = out
        return torch.cat([t.double().flatten() for t in
                          (*maps, *(t for pair in new_carries
                                    for t in pair))])

    before = epilogue.bn_act.launches
    with torch.inference_mode():
        fused, counts = _epilogue_counts(lambda: model(carries, x))
    assert counts == {"epilogue_fused": 13}
    assert epilogue.bn_act.launches == before + 13
    monkeypatch.setattr(epilogue, "KERNEL_DEVICE", "none")
    with torch.inference_mode():
        plain, counts = _epilogue_counts(lambda: model(carries, x))
        ref = _served_red(cuda, torch.float32)(carries, x)
    assert counts == {"epilogue_plain": 13}
    assert epilogue.bn_act.launches == before + 13
    assert _rel(flat(fused), flat(plain)) < 0.05
    assert _rel(flat(fused), flat(ref)) <= 1.02 * _rel(flat(plain),
                                                       flat(ref))


# RED served with each stream's memory carried (make_pipeline_recurrent)

def test_red_serving_on_card_matches_reference_and_records_memory(cuda):
    """RED at the red_gen4 cell's shapes (512x640, 65536 event slots, bf16
    model, f32 memory) with B = 2 over 8 windows against the benchmark's
    plain reference in f32 on the program's own volumes: each level's
    memory and the head outputs within the cell check's memory_gap and
    head_gap limits every window; under profiling.recording() `serve.memory` and
    `serve.backbone` carry device ms inside `serve.forward`, the counters
    read 2 fresh stream-windows then 14 carried, and B1 and B2 launch
    every step; then torch.cuda's sync debug mode warns once for each
    counted host sync (the NMS rounds') and for nothing else."""
    import json

    from evd_bench import weights
    from evd_bench.reference import red as ref
    from frlw_evd_tpu_torch.encode import scatter_cnt_tsum
    from frlw_evd_tpu_torch.models.detector import (RED_IN_CHANNELS,
                                                    RED_STRIDES)
    from frlw_evd_tpu_torch.utils import profiling

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = json.load(open(os.path.join(
        root, "evd_bench", "cells", "red_gen4_serve_b128.json")))
    limits = cell["check"]["limits"]
    hw, B, E, steps = (512, 640), 2, 65536, 8
    m = {"family": "red", "num_classes": 7, "input_channels": 16}
    params = weights.make_params(ref.param_spec(m), 0, cuda)
    model = build_detector(7, family="red", input_channels=16,
                           in_channels=RED_IN_CHANNELS, strides=RED_STRIDES)
    model.load_state_dict(params, strict=True)
    run = pipeline.make_pipeline_recurrent(model, hw, hw, device=cuda)
    net = ref.Net(params, m)
    heads = []
    hook = model.register_forward_hook(
        lambda mod, args, out: heads.append(out[1]))
    ev, nv = pipeline.synth_events_skewed(np.random.default_rng(3), steps,
                                          B, E, hw)
    ev, nv = torch.from_numpy(ev).to(cuda), torch.from_numpy(nv).to(cuda)
    b1, b2 = scatter_cnt_tsum.launches, taf_update_leaky.launches
    state, memory = pipeline.new_state(B, hw, device=cuda), None
    profiling.clear_spans()
    try:
        with profiling.recording():
            for i in range(steps):
                state, inp = run.stages["encode_transform"](state, ev[i],
                                                            nv[i])
                run.stages["detect"](inp)
                with torch.no_grad():
                    memory, outs = net(memory, inp.volume.float())
                for level, (mine, ref_pair) in enumerate(
                        zip(state.memory, memory)):
                    got = torch.cat([t.reshape(-1) for t in mine])
                    want = torch.cat([t.reshape(-1) for t in ref_pair])
                    assert _rel(got, want) <= limits["memory_gap"], (i, level)
                err = sum(float((a.double() - b.double()).norm() ** 2)
                          for a, b in zip(heads[-1], outs))
                ref_sq = sum(float(b.double().norm() ** 2) for b in outs)
                assert (err / ref_sq) ** 0.5 <= limits["head_gap"], i
        s = profiling.spans_summary()
    finally:
        hook.remove()
    assert scatter_cnt_tsum.launches - b1 == steps
    assert taf_update_leaky.launches - b2 == steps
    assert s["counts"]["memory_fresh"] == B
    assert s["counts"]["memory_carried"] == B * (steps - 1)
    spans = s["spans"]
    for name in ("serve.backbone", "serve.memory", "serve.forward"):
        assert spans[name]["device_ms"] > 0, name
    assert spans["serve.memory"]["device_ms"] + spans["serve.backbone"][
        "device_ms"] <= spans["serve.forward"]["device_ms"]

    # two more steps: the NMS rounds' are the only host syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")     # its first call warns once
    profiling.clear_spans()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profiling.recording():
            warnings.simplefilter("always")
            for i in range(2):
                state, _ = run(state, ev[i], nv[i])
            warned = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = profiling.spans_summary()["counts"]
    assert counts["host_syncs"] == len(warned) >= 2
    assert counts["memory_carried"] == 2 * B
