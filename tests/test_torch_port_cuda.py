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
    conv = torch.nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=bias,
                           device=cuda)
    q = torch.randint(-127, 128, (cout, cin, k, k), device=cuda,
                      generator=g, dtype=torch.int8)
    sw = torch.rand(cout, device=cuda, generator=g) * 1e-2
    site = quantize.Int8Site(conv, 5.0 / 127.0, q, sw)
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


def test_int8_path_on_card_matches_cpu(cuda):
    """The int8 GEN1 slice at a small size: calibrate_pipeline on the card
    (bf16) and on the CPU (f32) find the same sites, scales within 5e-2
    (bf16 against f32 activations); with the CPU's (scales, table) in
    both, every site launches once a forward on the card, the card's int8
    maps are within relative L2 0.08 of its bf16 maps (the serving form's
    gate, tests/test_quantize.py:132), and within 0.08 of the same bf16
    model's int8 maps on the CPU (the twins; the frameworks' bf16 convs
    and the codes they feed round apart)."""
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
    c_model.to(torch.bfloat16)
    c_int8 = maps(c_model, g_vol.cpu(), c_quant)
    for lvl, (q, b, c) in enumerate(zip(g_int8, g_bf16, c_int8)):
        assert 0 < rel(q, b) < 0.08, (lvl, rel(q, b))
        assert rel(q, c) < 0.08, (lvl, rel(q, c))


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
