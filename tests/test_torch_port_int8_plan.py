"""The int8 conv's tiling (models/quantize.py::tile_plan) on the CPU.

csrc/int8_conv.cu takes its tiling from `tile_plan` as it is: tile sizes,
pipeline stages, shared memory, the persistent grid and the producer
warpgroups. These tests hold the plan at every int8 site shape of the GEN1
and the gen4 AED at B = 128 (found by hooks on a forward on the meta
device, so no activation is computed) and at the ragged shapes of
tests/test_torch_port_cuda.py's INT8_SHAPES: the tiles that the blocks
walk (`plan_tiles`, the kernel's walk) cover every output pixel and
channel exactly once; the shared memory fits an H100 block; one tile takes
all of Cout where Cout <= 256; the (Cout, k*k*Cin) matrix that the
weights' TMA map reads is a view of the OHWI codes that round-trips; and
the kernel's quantization (a bf16 clamp to [-B, B] in place of the clip,
`clamp_bits`) gives the twin's codes for every bf16 value.
"""

from __future__ import annotations

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch.kernels import int8_probe
from frlw_evd_tpu_torch.models import build_detector
from frlw_evd_tpu_torch.models import quantize as q
from test_torch_port_cuda import INT8_SHAPES

B = 128
MODELS = {"GEN1": (2, (256, 320, 16)), "gen4": (7, (512, 640, 16))}


@functools.lru_cache(maxsize=None)
def site_shapes(name):
    """{(k, stride, Cin, Cout, H, W): sites} of the AED's int8 sites at the
    model's input (gen4 through the bfm stem at the sensor size, which
    feeds the backbone the shapes the folded p64 stem does)."""
    classes, input_shape = MODELS[name]
    with torch.device("meta"):
        model = build_detector(classes, stem="bfm").eval()
    shapes = Counter()

    def record(conv):
        def hook(_module, args):
            shapes[(conv.kernel_size[0], conv.stride[0], conv.in_channels,
                    conv.out_channels, *args[0].shape[2:])] += 1
        return hook
    for conv in q.eligible_sites(model).values():
        conv.register_forward_pre_hook(record(conv))
    with torch.inference_mode():
        model(torch.zeros(1, *input_shape, device="meta"))
    return dict(shapes)


def _out_pixels(n, k, stride, h, w):
    pad = (k - 1) // 2
    return n * ((h + 2 * pad - k) // stride + 1) * ((w + 2 * pad - k)
                                                    // stride + 1)


def _check_plan(n, k, stride, cin, cout, h, w):
    plan = q.tile_plan(n, h, w, cin, cout, k, stride)
    gy = -(-cout // plan.bn)
    assert plan.bm in (64, 128) and plan.bn in q.WGMMA_N
    assert plan.tiles == -(-plan.rows // plan.bm) * gy
    assert plan.grid == min(plan.tiles, q.SMS)
    assert 2 <= plan.stages <= q.MAX_STAGES and plan.smem <= 232448
    if plan.halo:
        # 3x3, whole 64- or 128-channel blocks; rows walk the halo grid,
        # each output pixel one of them
        assert (k, cin % plan.slab, plan.bm) == (3, 0, 128)
        hg, wg, _ = q.halo_grid(h, w, stride)
        assert hg >= _out_pixels(1, k, stride, h, 1) + (3 - stride)
        assert wg >= _out_pixels(1, k, stride, 1, w) + (3 - stride)
        assert plan.rows == n * hg * wg and plan.producers == 1
        assert plan.smem == (1024 + q._halo_bytes(w, plan.slab, stride) + 32
                             + 8 * q.EPI_BYTES
                             + plan.stages * (plan.bn * plan.slab + 16))
    else:
        assert plan.rows == _out_pixels(n, k, stride, h, w)
        assert plan.slab == q.SLAB
        # stages of (bm + bn) x SLAB codes and two barriers, AHEAD + 1 bf16
        # staging slabs, the consumer warps' scratch and the alignment slack
        warps = 8 if plan.pingpong else plan.bm // 16
        assert plan.pingpong == (k == 1)
        assert plan.bm == 64 or not plan.pingpong
        assert plan.smem == (1024 + (q.AHEAD + 1) * plan.bm * 2 * q.SLAB
                             + warps * q.EPI_BYTES
                             + plan.stages
                             * ((plan.bm + plan.bn) * q.SLAB + 16))
        # two 256-wide consumer warpgroups leave registers for one producer
        # warpgroup only
        assert plan.producers == (1 if warps == 8 and plan.bn == 256 else 2)
    if cout <= 256:
        assert gy == 1 and plan.bn >= cout
        assert plan.bn == min(n_ for n_ in q.WGMMA_N if n_ >= cout)
    # every row (output pixel, or padded position) and channel in exactly
    # one tile of one block
    seen = np.zeros((-(-plan.rows // plan.bm), gy), np.int64)
    covered = 0
    for block in range(plan.grid):
        for rows, cols in q.plan_tiles(plan, block, cout):
            assert rows.start % plan.bm == 0 and cols.start % plan.bn == 0
            assert 0 < len(rows) <= plan.bm and 0 < len(cols) <= plan.bn
            seen[rows.start // plan.bm, cols.start // plan.bn] += 1
            covered += len(rows) * len(cols)
    assert (seen == 1).all() and covered == plan.rows * cout
    return plan


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_tiles_every_aed_site_once(name):
    shapes = site_shapes(name)
    assert sum(shapes.values()) == 61 and len(shapes) == 28
    for k, stride, cin, cout, h, w in shapes:
        plan = _check_plan(B, k, stride, cin, cout, h, w)
        assert plan.bn == cout          # 64, 128 or 256: one tile wide
        assert plan.bm == (64 if k == 1 else 128)   # 1x1: ping-pong tiles
        # every 3x3 stride-1 site; at stride 2 those whose 128-channel
        # halo fits (Cin 256 at 32 x 40 or less)
        if k == 1 or stride == 1:
            assert plan.halo == (k == 3)
        else:
            assert plan.halo == (cin == 256 and w <= 40), (cin, h, w)
            assert not plan.halo or plan.slab == 128


@pytest.mark.parametrize("n", [1, 3, 128])
@pytest.mark.parametrize("k,stride,cin,cout,h,w", INT8_SHAPES)
def test_plan_tiles_ragged_shapes_once(k, stride, cin, cout, h, w, n):
    _check_plan(n, k, stride, cin, cout, h, w)


def test_plan_takes_64_pixel_tiles_where_128_would_idle_half_the_sms():
    small = q.tile_plan(3, 16, 20, 96, 256, 3, 2)     # 240 pixels
    assert (small.bm, small.bn, small.producers) == (64, 256, 2)
    assert not small.pingpong and not small.halo
    assert q.tile_plan(B, 16, 20, 96, 256, 3, 2).bm == 128


def test_plan_leaves_the_halo_where_it_does_not_fit():
    """A 3x3 stride-1 site too wide for two halo stages and two weight
    stages takes the general kernel."""
    assert q.tile_plan(1, 8, 2000, 128, 256, 3, 1).halo is False
    assert q.tile_plan(1, 8, 2000, 128, 256, 3, 1).stages >= 2


@pytest.mark.parametrize("cin", [64, 128])
def test_plan_takes_several_channel_tiles_past_256(cin):
    plan = _check_plan(2, 3, 1, cin, 320, 9, 11)
    assert plan.bn == 256 and plan.tiles == -(-plan.rows // plan.bm) * 2


@pytest.mark.parametrize("k", [1, 3])
def test_weight_matrix_round_trips_to_the_codes(k):
    """The TMA map's (Cout, k*k*Cin) matrix is a view of the OHWI codes
    (no copy), K in (tap, channel) order, and reshapes back to them; the
    OHWI codes are the OIHW table's (Int8Site) transposed."""
    rng = np.random.default_rng(k)
    oihw = torch.from_numpy(rng.integers(-127, 128, (40, 64, k, k),
                                         dtype=np.int8))
    ohwi = oihw.permute(0, 2, 3, 1).contiguous()
    mat = q.weight_matrix(ohwi)
    assert mat.shape == (40, k * k * 64) and mat.data_ptr() == ohwi.data_ptr()
    assert torch.equal(mat.reshape(40, k, k, 64).permute(0, 3, 1, 2), oihw)
    for co, ky, kx, ci in ((0, 0, 0, 0), (39, k - 1, k - 1, 63),
                           (7, k // 2, 0, 33)):
        assert mat[co, (ky * k + kx) * 64 + ci] == oihw[co, ci, ky, kx]


@pytest.mark.parametrize("inv", [127 / 3, 127 / 5, 81.30081, 7.77, 12345.6,
                                 1e-3, 1.27e14])
def test_bf16_clamp_gives_the_twins_codes_for_every_bf16(inv):
    """The kernel's codes (x clamped to [-B, B] in bf16, B = clamp_bits,
    then round_half_even(f32(x) * f32(inv)) with no clip) equal
    quantize_activation's clip(round_half_even(f32(x) * inv), -127, 127)
    for every finite bf16 x and both infinities."""
    bits = np.arange(0x10000, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]                 # finite
    bits = np.concatenate([bits, [0x7F80, 0xFF80]])           # +-inf
    x = (bits << 16).view(np.float32)
    b = np.array([q.clamp_bits(inv) << 16], np.uint32).view(np.float32)[0]
    with np.errstate(over="ignore", invalid="ignore"):
        kernel = np.round(np.clip(x, -b, b) * np.float32(inv))
    twin = q.quantize_activation(torch.from_numpy(x), inv).numpy()
    np.testing.assert_array_equal(kernel, twin)
    assert np.abs(kernel).max() == 127


@pytest.mark.parametrize("name", sorted(int8_probe.VARIANTS))
def test_probe_variants_still_apply_to_the_kernel_source(name):
    """Each ablation of kernels/int8_probe.py edits csrc/int8_conv.cu at
    places that exist exactly once, so the probe measures what it says."""
    text = int8_probe.variant_source(name)
    assert (text == (q._build.CSRC / "int8_conv.cu").read_text()) == (
        name == "base")
