"""Fused TAF queue update + leaky transform, kernels B2, B3 and B5
(counterpart of frlw_evd_tpu/encode/pallas_update.py::taf_update_leaky,
taf_update_leaky_raw, taf_update_leaky_v2, taf_stream_step_kernel and
taf_stream_step_kernel_p64).

The GEN1 TAF queue lives folded as (B, H, W*2K) f32: within each pixel's 2K
block, position c = 2*age + p, newest first. `taf_update_leaky` (B2) applies
one bin to it in place from kernel B1's count/t-sum planes and returns the
(B, H, W*2K) bf16 detector volume in [0, 1].

The 1 Mpx queue is patchified (p64): (B, H/2, (W/2)*64) f32, per
quarter-resolution pixel 4 subpixel blocks (s = (x&1)*2 + (y&1)) of 2K = 16
positions, so the volume is already space-to-depth'd for the p64 stems.
`taf_update_leaky_raw` (B3) applies one bin to it from B1's p64-order
planes, `taf_update_leaky_v2` (B5) from (B, H/2, (W/2)*8) planes in
(pixel, subpixel, polarity) order, the same bytes in the same order. A
K = 4 p64 queue (2K = 8 positions a subpixel block) is B2's folded queue
of an (H/2, (W/2)*4) grid, and the step updates it with B2, as does the
folded step of streaming.py. CUDA tensors launch `csrc/taf_update.cu`;
CPU tensors run the plain twins.

The steps take JAX's `scatter` and `precise` (pallas_update.py:121-140,
:343-393): "pallas" with precise=False is kernel B1; "pallas" with
precise=True is kernel B6 on the steps' cell indices; "sorted" is the plain
`scatter_cnt_tsum_sorted`. On the p64 queue, B1 feeds B3 and the other two
feed B5.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import _build
from ..utils.profiling import span
from .scatter import (event_cells, scatter_cnt_tsum,
                      scatter_cnt_tsum_pallas_sorted, scatter_cnt_tsum_sorted)
from .taf import INIT_VALUE, _leaky_unit


def init_state(batch: int, height: int, width: int, K: int = 8, *,
               device="cuda") -> torch.Tensor:
    """Fresh folded queue (B, H, W*2K) f32 filled with -6000 (bench.py:910)."""
    return torch.full((batch, height, width * 2 * K), INIT_VALUE,
                      dtype=torch.float32, device=device)


def _check_inputs(state_f, cnt, tsum, any_ev, height, width):
    B, H, WF = state_f.shape
    if state_f.dtype != torch.float32 or H != height or WF % width:
        raise ValueError(f"state_f must be (B, {height}, {width}*2K) f32, got "
                         f"{tuple(state_f.shape)} {state_f.dtype}")
    P = height * width * 2
    for name, t in (("cnt", cnt), ("tsum", tsum)):
        if t.shape != (B, P) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {P}) f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any_ev.shape != (B,):
        raise ValueError(f"any_ev must be ({B},), got {tuple(any_ev.shape)}")
    for t in (cnt, tsum, any_ev):
        if t.device != state_f.device:
            raise ValueError(f"state_f on {state_f.device} but an input on "
                             f"{t.device}")


def _launch(entry: str, state_f, cnt, tsum, any_ev, dims) -> torch.Tensor:
    """Launch the C entry `entry` of csrc/taf_update.cu on CUDA tensors,
    state_f in place; returns the bf16 volume."""
    if not state_f.is_contiguous() or state_f.data_ptr() % 16:
        raise ValueError("state_f must be contiguous and 16-byte aligned")
    vol = torch.empty(state_f.shape, dtype=torch.bfloat16,
                      device=state_f.device)
    _build.launch("taf_update", entry,
                  (state_f, cnt.contiguous(), tsum.contiguous(),
                   any_ev.to(torch.int32).contiguous(), vol), dims,
                  state_f.device)
    return vol


def taf_update_leaky_plain(state_f, cnt, tsum, any_ev, *, height: int,
                           width: int):
    """Plain-PyTorch twin of kernel B2 (any device); same contract as
    `taf_update_leaky`, state updated in place."""
    _check_inputs(state_f, cnt, tsum, any_ev, height, width)
    B, H, WF = state_f.shape
    C = WF // width
    s = state_f.view(B, H, width, C)
    c = cnt.view(B, H, width, 2)
    has = c > 0
    tm = torch.where(has, tsum.view(B, H, width, 2) / (c + 1e-8), -2.0)
    tm = tm.to(torch.bfloat16).to(torch.float32)
    aged = s - 1.0
    # position c reads cell c % 2: c < 2 takes the new mean, the rest shift
    # up by one age step within the pixel
    shifted = torch.cat([tm, aged[..., :-2]], dim=-1)
    upd = torch.where(has.repeat(1, 1, 1, C // 2), shifted, aged)
    upd = torch.where(any_ev.view(B, 1, 1, 1) != 0, upd, s)
    state_f.copy_(upd.view(B, H, WF))
    vol = _leaky_unit(upd).to(torch.bfloat16)
    return state_f, vol.view(B, H, WF)


def taf_update_leaky(state_f, cnt, tsum, any_ev, *, height: int, width: int):
    """Queue update + empty-stream freeze + leaky transform, fused.

    Args:
      state_f: (B, H, W*2K) f32 folded queue. Updated IN PLACE, as the
        aliased TPU call (pallas_update.py:89) does.
      cnt, tsum: (B, H*W*2) f32 per-cell count and t-sum (kernel B1).
      any_ev: (B,) int32, nonzero where the stream had any event this bin;
        a stream without events keeps its state (the reference freeze).
    Returns (state_f, vol) with vol (B, H, W*2K) bf16 in [0, 1].

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `taf_update_leaky.launches`) or raise.
    """
    if state_f.device.type == "cpu":
        with span("kernel.b2"):
            return taf_update_leaky_plain(state_f, cnt, tsum, any_ev,
                                          height=height, width=width)
    if state_f.device.type != "cuda":
        raise ValueError(f"taf_update_leaky: unsupported device "
                         f"{state_f.device}")
    _check_inputs(state_f, cnt, tsum, any_ev, height, width)
    B, H, WF = state_f.shape
    C = WF // width
    if C not in (8, 16):
        raise ValueError(f"taf_update_leaky kernel takes 2K in (8, 16), got {C}")
    with span("kernel.b2"):
        vol = _launch("taf_update_leaky", state_f, cnt, tsum, any_ev,
                      (B, H, width, C))
        taf_update_leaky.launches += 1
    return state_f, vol


taf_update_leaky.launches = 0


def p64_init_state(batch: int, height: int, width: int, K: int = 8, *,
                   device="cuda") -> torch.Tensor:
    """Fresh patchified queue (B, H/2, (W/2)*4*2K) f32 filled with -6000
    (pallas_update.py:298-301)."""
    return torch.full((batch, height // 2, (width // 2) * 4 * 2 * K),
                      INIT_VALUE, dtype=torch.float32, device=device)


def _check_p64_geometry(state_f, height: int, width: int,
                        Ks=(8,)) -> int:
    """The p64 queue's K, from the state's width (W/2)*4*2K; refuses a K
    outside `Ks`, an odd sensor, and (W/2) % 16 != 0 at K = 8, as the TPU
    kernels assert (pallas_update.py:266-268). Kernel B3 takes K = 8; the
    step takes K = 8 and K = 4, whose 2K = 8 is what B2's body takes on the
    card (its twin refuses the same)."""
    B, H2, WF = state_f.shape
    W2 = width // 2
    if height % 2 or width % 2 or H2 != height // 2 or WF % (W2 * 8):
        raise ValueError(f"the p64 queue of a {height}x{width} sensor is "
                         f"(B, {height // 2}, {W2}*4*2K), got "
                         f"{tuple(state_f.shape)}")
    K = WF // (W2 * 8)
    if K not in Ks:
        raise ValueError(f"the p64 step takes K in {Ks}, got K = {K}")
    if K == 8 and W2 % 16:
        raise ValueError(f"the p64 update at K = 8 needs (W/2) % 16 == 0, "
                         f"got {height}x{width}")
    return K


def taf_update_leaky_raw_plain(state_f, cnt, tsum, any_ev, *, height: int,
                               width: int):
    """Plain-PyTorch twin of kernel B3 (any device), written from the p64
    statement: the per-cell mean is expanded to the queue channels through
    the cell → channel map s*16 + 2a + p ← s*2 + p, then the shift within
    each 16-channel subpixel block, the freeze and the leaky volume."""
    _check_p64_geometry(state_f, height, width)
    _check_inputs(state_f, cnt, tsum, any_ev, height // 2, width * 2)
    B, H2, WF = state_f.shape
    W2 = width // 2
    s = state_f.view(B, H2, W2, 64)
    ch = torch.arange(64, device=state_f.device)
    cell_of = (ch // 16) * 2 + ch % 2            # channel → cell of its pixel
    pos = ch % 16                                # queue position c = 2a + p
    c = cnt.view(B, H2, W2, 8)
    tm = torch.where(c > 0, tsum.view(B, H2, W2, 8) / (c + 1e-8), -2.0)
    tm = tm.to(torch.bfloat16).to(torch.float32)
    has = (c > 0)[..., cell_of]
    aged = s - 1.0
    older = aged[..., torch.where(pos >= 2, ch - 2, ch)]
    upd = torch.where(has, torch.where(pos < 2, tm[..., cell_of], older),
                      aged)
    upd = torch.where(any_ev.view(B, 1, 1, 1) != 0, upd, s)
    state_f.copy_(upd.view(B, H2, WF))
    vol = _leaky_unit(upd).to(torch.bfloat16)
    return state_f, vol.view(B, H2, WF)


def taf_update_leaky_raw(state_f, cnt, tsum, any_ev, *, height: int,
                         width: int):
    """Queue update + freeze + leaky on the patchified p64 queue, fused.

    Args:
      state_f: (B, H/2, (W/2)*64) f32 p64 queue (K = 8). Updated IN PLACE,
        as the aliased TPU call (pallas_update.py:291) does.
      cnt, tsum: (B, H*W*2) f32 per-cell count and t-sum in B1's p64 order.
      any_ev: (B,) int32, nonzero where the stream had any event this bin.
      height, width: the sensor's; (W/2) % 16 == 0.
    Returns (state_f, vol) with vol (B, H/2, (W/2)*64) bf16 in [0, 1].

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `taf_update_leaky_raw.launches`) or raise.
    """
    if state_f.device.type == "cpu":
        with span("kernel.b3"):
            return taf_update_leaky_raw_plain(state_f, cnt, tsum, any_ev,
                                              height=height, width=width)
    if state_f.device.type != "cuda":
        raise ValueError(f"taf_update_leaky_raw: unsupported device "
                         f"{state_f.device}")
    _check_p64_geometry(state_f, height, width)
    _check_inputs(state_f, cnt, tsum, any_ev, height // 2, width * 2)
    B, H2, _ = state_f.shape
    with span("kernel.b3"):
        vol = _launch("taf_update_leaky_raw", state_f, cnt, tsum, any_ev,
                      (B, H2, width // 2))
        taf_update_leaky_raw.launches += 1
    return state_f, vol


taf_update_leaky_raw.launches = 0


def _check_v2(state_f, cnt_r, tsum_r, any_ev, height: int,
              width: int) -> None:
    """The contract of pallas_update.py:193-207: height = H/2 rows and
    width = (W/2)*4 subpixel columns, as the p64 step passes them
    (:379-380); K = 8 and (W/2) % 16 == 0, as the TPU kernel asserts."""
    B, H2, WF = state_f.shape
    if state_f.dtype != torch.float32 or H2 != height or width % 4 \
            or WF != width * 16:
        raise ValueError(f"taf_update_leaky_v2 needs K = 8: state (B, "
                         f"{height}, {width * 16}) f32, got "
                         f"{tuple(state_f.shape)} {state_f.dtype}")
    W2 = width // 4
    if W2 % 16:
        raise ValueError(f"taf_update_leaky_v2 needs (W/2) % 16 == 0, got "
                         f"W/2 = {W2}")
    for name, t in (("cnt_r", cnt_r), ("tsum_r", tsum_r)):
        if t.shape != (B, H2, W2 * 8) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {H2}, {W2 * 8}) f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if any_ev.shape != (B,):
        raise ValueError(f"any_ev must be ({B},), got {tuple(any_ev.shape)}")
    for t in (cnt_r, tsum_r, any_ev):
        if t.device != state_f.device:
            raise ValueError(f"state_f on {state_f.device} but an input on "
                             f"{t.device}")


@functools.cache
def _expansion_matrix() -> torch.Tensor:
    """(128, 8*128) 0/1 as pallas_update.py:172-190 builds it for K = 8:
    local cell lx*8 + s*2 + p of a 16-pixel block → its 8 queue channels
    lx*64 + s*16 + 2a + p."""
    cell = torch.arange(128)
    lx, s, p = cell // 8, cell // 2 % 4, cell % 2
    first = lx * 64 + s * 16 + p                  # the cell's age-0 channel
    out = torch.zeros(128, 8 * 128)
    out[cell[:, None], first[:, None] + 2 * torch.arange(8)] = 1.0
    return out


def taf_update_leaky_v2_plain(state_f, cnt_r, tsum_r, any_ev, *, height: int,
                              width: int):
    """Plain-PyTorch twin of kernel B5 (any device), written from the TPU
    kernel's statement (pallas_update.py:143-169): the per-cell mean in
    bf16, -2 where the cell had no event, times the 0/1 expansion matrix
    (each channel takes exactly one cell, so the product is exact); a
    channel whose value is above -1.5 had events; then the shift within
    each 16-channel subpixel block, the freeze and the leaky volume."""
    _check_v2(state_f, cnt_r, tsum_r, any_ev, height, width)
    B, H2, WF = state_f.shape
    tm_small = torch.where(cnt_r > 0, tsum_r / (cnt_r + 1e-8), -2.0)
    m = _expansion_matrix().to(state_f.device, torch.bfloat16)
    tm = (tm_small.reshape(-1, 128).to(torch.bfloat16) @ m).to(
        torch.float32).view(B, H2, WF)
    has = tm > -1.5
    aged = state_f - 1.0
    shifted = torch.cat([torch.zeros_like(aged[..., :2]), aged[..., :-2]], -1)
    first = torch.arange(WF, device=state_f.device) % 16 < 2
    upd = torch.where(has, torch.where(first, tm, shifted), aged)
    upd = torch.where(any_ev.view(B, 1, 1) != 0, upd, state_f)
    state_f.copy_(upd)
    return state_f, _leaky_unit(upd).to(torch.bfloat16)


def taf_update_leaky_v2(state_f, cnt_r, tsum_r, any_ev, *, height: int,
                        width: int):
    """Queue update + freeze + leaky on the p64 queue from plane-shaped
    histograms, fused (pallas_update.py:193-230).

    Args:
      state_f: (B, H2, W2*64) f32 p64 queue (K = 8). Updated IN PLACE, as
        the aliased TPU call does.
      cnt_r, tsum_r: (B, H2, W2*8) f32 per-cell count and t-sum in (pixel,
        subpixel, polarity) order.
      any_ev: (B,) int, nonzero where the stream had any event this bin.
      height, width: H2 and W2*4, as the p64 step passes them; W2 % 16 == 0.
    Returns (state_f, vol) with vol (B, H2, W2*64) bf16 in [0, 1].

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `taf_update_leaky_v2.launches`) or raise.
    """
    if state_f.device.type == "cpu":
        return taf_update_leaky_v2_plain(state_f, cnt_r, tsum_r, any_ev,
                                         height=height, width=width)
    if state_f.device.type != "cuda":
        raise ValueError(f"taf_update_leaky_v2: unsupported device "
                         f"{state_f.device}")
    _check_v2(state_f, cnt_r, tsum_r, any_ev, height, width)
    vol = _launch("taf_update_leaky_v2", state_f, cnt_r, tsum_r, any_ev,
                  (state_f.shape[0], height, width // 4))
    taf_update_leaky_v2.launches += 1
    return state_f, vol


taf_update_leaky_v2.launches = 0


SCATTERS = ("pallas", "sorted")


def _cell_histogram(xytp, n_valid, height: int, width: int, layout: str,
                    scatter: str, precise: bool):
    """(cnt, tsum (B, H*W*2) f32, any_ev (B,) int32) of one bin in `layout`:
    kernel B1 for scatter="pallas" with precise=False, kernel B6 with
    precise=True, `scatter_cnt_tsum_sorted` for scatter="sorted", the last
    two over the cells that B1 would count (`event_cells`)."""
    if scatter == "pallas" and not precise:
        return scatter_cnt_tsum(xytp, n_valid, height=height, width=width,
                                layout=layout)
    idx, tv, valid = event_cells(xytp, n_valid, height, width, layout)
    size = height * width * 2
    if scatter == "pallas":
        cnt, tsum = scatter_cnt_tsum_pallas_sorted(idx, tv, valid, size)
    else:
        cnt, tsum = scatter_cnt_tsum_sorted(idx, tv, valid, size, precise)
    return cnt, tsum, (cnt > 0).any(dim=1).to(torch.int32)


def _check_scatter(step: str, scatter: str) -> None:
    if scatter not in SCATTERS:
        raise ValueError(f"{step} supports scatter 'pallas' or 'sorted', got "
                         f"{scatter!r}")


def taf_stream_step_kernel(state_f, xytp, n_valid, *, height: int,
                           width: int, scatter: str = "pallas",
                           precise: bool = False):
    """One streaming TAF step on the folded state (pallas_update.py:98-140):
    histogram, then fused update + leaky (B2). The histogram is kernel B1
    for scatter="pallas" with precise=False, kernel B6 with precise=True,
    and `scatter_cnt_tsum_sorted` for scatter="sorted".

    Returns (state_f, vol (B, H, W, 2K) bf16 in [0, 1]); state_f is the
    input tensor, updated in place."""
    _check_scatter("taf_stream_step_kernel", scatter)
    cnt, tsum, any_ev = _cell_histogram(xytp, n_valid, height, width,
                                        "folded", scatter, precise)
    state_f, vol = taf_update_leaky(state_f, cnt, tsum, any_ev,
                                    height=height, width=width)
    B, H, WF = state_f.shape
    return state_f, vol.view(B, H, width, WF // width)


def taf_stream_step_kernel_p64(state_f, xytp, n_valid, any_events=None, *,
                               height: int, width: int,
                               scatter: str = "pallas", precise: bool = False,
                               fold_output: bool = False):
    """One streaming TAF step on the patchified p64 queue
    (pallas_update.py:304-393), K from the state's width: 8 or 4.

    At K = 8, scatter="pallas" with precise=False is the raw path: B1 in
    the p64 cell order, then the fused update + leaky (B3). scatter="pallas"
    with precise=True runs kernel B6 on the same cells, scatter="sorted"
    runs `scatter_cnt_tsum_sorted`, and both then the update from
    plane-shaped histograms (B5).

    At K = 4 the same three histograms (B1, B6, sorted) feed B2: the p64
    cell order ((y2*W2 + x2)*4 + s)*2 + p is the folded (y*W + x)*2 + p
    order of an (H/2, (W/2)*4) grid of subpixel columns, whose 2K = 8
    queue positions are one subpixel block, so the planes go to B2 as they
    are and B2 takes JAX's bf16 mean (:381-389) inside itself.

    any_events: optional (B,) flags that replace the per-stream any-event
    flag (B1's, or cnt > 0 off the raw path), for spatially sharded callers
    that must pass the global one (a shard with no local events still ages
    with the rest of the frame).
    Returns (state_f, vol), state_f updated in place; vol (B, H/2,
    (W/2)*8K) bf16 folded when fold_output, else its (B, H/2, W/2, 8K)
    view."""
    _check_scatter("taf_stream_step_kernel_p64", scatter)
    K = _check_p64_geometry(state_f, height, width, Ks=(8, 4))
    B, H2, WF = state_f.shape
    W2 = width // 2
    cnt, tsum, any_ev = _cell_histogram(xytp, n_valid, height, width, "p64",
                                        scatter, precise)
    if any_events is not None:
        any_ev = any_events.to(device=any_ev.device, dtype=torch.int32)
    if K != 8:
        update = taf_update_leaky
        hw = dict(height=H2, width=W2 * 4)
    elif scatter == "pallas" and not precise:
        update = taf_update_leaky_raw
        hw = dict(height=height, width=width)
    else:
        cnt, tsum = cnt.view(B, H2, -1), tsum.view(B, H2, -1)
        update = taf_update_leaky_v2
        hw = dict(height=H2, width=W2 * 4)
    state_f, vol = update(state_f, cnt, tsum, any_ev, **hw)
    if fold_output:
        return state_f, vol
    return state_f, vol.view(B, H2, W2, 8 * K)
