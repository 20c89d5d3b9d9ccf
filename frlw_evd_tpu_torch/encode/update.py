"""Fused TAF queue update + leaky transform, kernels B2 and B3
(counterpart of frlw_evd_tpu/encode/pallas_update.py::taf_update_leaky,
taf_update_leaky_raw, taf_stream_step_kernel and
taf_stream_step_kernel_p64).

The GEN1 TAF queue lives folded as (B, H, W*2K) f32: within each pixel's 2K
block, position c = 2*age + p, newest first. `taf_update_leaky` (B2) applies
one bin to it in place from kernel B1's count/t-sum planes and returns the
(B, H, W*2K) bf16 detector volume in [0, 1].

The 1 Mpx queue is patchified (p64): (B, H/2, (W/2)*64) f32, per
quarter-resolution pixel 4 subpixel blocks (s = (x&1)*2 + (y&1)) of 2K = 16
positions, so the volume is already space-to-depth'd for the p64 stems.
`taf_update_leaky_raw` (B3) applies one bin to it from B1's p64-order
planes. CUDA tensors launch `csrc/taf_update.cu`; CPU tensors run the plain
twins.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build
from .scatter import scatter_cnt_tsum
from .taf import INIT_VALUE, leaky_transform


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
    vol = leaky_transform(upd).to(torch.bfloat16)
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
    if not state_f.is_contiguous() or state_f.data_ptr() % 16:
        raise ValueError("state_f must be contiguous and 16-byte aligned")
    cnt, tsum = cnt.contiguous(), tsum.contiguous()
    any_ev = any_ev.to(torch.int32).contiguous()
    vol = torch.empty(B, H, WF, dtype=torch.bfloat16, device=state_f.device)
    lib = _build.load("taf_update")
    fn = lib.taf_update_leaky
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(state_f.device).cuda_stream
    rc = fn(state_f.data_ptr(), cnt.data_ptr(), tsum.data_ptr(),
            any_ev.data_ptr(), vol.data_ptr(), B, H, width, C, stream)
    _build.check(rc, "taf_update_leaky")
    taf_update_leaky.launches += 1
    return state_f, vol


taf_update_leaky.launches = 0


def p64_init_state(batch: int, height: int, width: int, K: int = 8, *,
                   device="cuda") -> torch.Tensor:
    """Fresh patchified queue (B, H/2, (W/2)*4*2K) f32 filled with -6000
    (pallas_update.py:298-301)."""
    return torch.full((batch, height // 2, (width // 2) * 4 * 2 * K),
                      INIT_VALUE, dtype=torch.float32, device=device)


def _check_p64_geometry(state_f, height: int, width: int) -> None:
    """The p64 update takes K = 8 and (W/2) % 16 == 0 only, as the TPU
    kernel asserts (pallas_update.py:266-268); the twin refuses the same."""
    if height % 2 or width % 2 or (width // 2) % 16:
        raise ValueError(f"the p64 update needs an even sensor with "
                         f"(W/2) % 16 == 0, got {height}x{width}")
    B, H2, WF = state_f.shape
    if H2 != height // 2 or WF != (width // 2) * 64:
        raise ValueError(f"the p64 update needs K = 8: state (B, "
                         f"{height // 2}, {(width // 2) * 64}), got "
                         f"{tuple(state_f.shape)}")


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
    vol = leaky_transform(upd).to(torch.bfloat16)
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
        return taf_update_leaky_raw_plain(state_f, cnt, tsum, any_ev,
                                          height=height, width=width)
    if state_f.device.type != "cuda":
        raise ValueError(f"taf_update_leaky_raw: unsupported device "
                         f"{state_f.device}")
    _check_p64_geometry(state_f, height, width)
    _check_inputs(state_f, cnt, tsum, any_ev, height // 2, width * 2)
    if not state_f.is_contiguous() or state_f.data_ptr() % 16:
        raise ValueError("state_f must be contiguous and 16-byte aligned")
    cnt, tsum = cnt.contiguous(), tsum.contiguous()
    any_ev = any_ev.to(torch.int32).contiguous()
    B, H2, WF = state_f.shape
    vol = torch.empty(B, H2, WF, dtype=torch.bfloat16, device=state_f.device)
    lib = _build.load("taf_update")
    fn = lib.taf_update_leaky_raw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(state_f.device).cuda_stream
    rc = fn(state_f.data_ptr(), cnt.data_ptr(), tsum.data_ptr(),
            any_ev.data_ptr(), vol.data_ptr(), B, H2, width // 2, stream)
    _build.check(rc, "taf_update_leaky_raw")
    taf_update_leaky_raw.launches += 1
    return state_f, vol


taf_update_leaky_raw.launches = 0


def taf_stream_step_kernel(state_f, xytp, n_valid, *, height: int,
                           width: int):
    """One streaming TAF step on the folded state (pallas_update.py:98-140):
    histogram (B1) then fused update + leaky (B2).

    Returns (state_f, vol (B, H, W, 2K) bf16 in [0, 1]); state_f is the
    input tensor, updated in place."""
    cnt, tsum, any_ev = scatter_cnt_tsum(xytp, n_valid, height=height,
                                         width=width)
    state_f, vol = taf_update_leaky(state_f, cnt, tsum, any_ev,
                                    height=height, width=width)
    B, H, WF = state_f.shape
    return state_f, vol.view(B, H, width, WF // width)


def taf_stream_step_kernel_p64(state_f, xytp, n_valid, any_events=None, *,
                               height: int, width: int,
                               fold_output: bool = False):
    """One streaming TAF step on the patchified p64 queue, the raw path of
    pallas_update.py:304-361: histogram in the p64 cell order (B1), then
    the fused update + leaky (B3).

    any_events: optional (B,) flags that replace B1's per-stream any-event
    flag, for spatially sharded callers that must pass the global one (a
    shard with no local events still ages with the rest of the frame).
    Returns (state_f, vol), state_f updated in place; vol (B, H/2,
    (W/2)*64) bf16 folded when fold_output, else its (B, H/2, W/2, 64)
    view."""
    _check_p64_geometry(state_f, height, width)
    cnt, tsum, any_ev = scatter_cnt_tsum(xytp, n_valid, height=height,
                                         width=width, layout="p64")
    if any_events is not None:
        any_ev = any_events.to(device=any_ev.device, dtype=torch.int32)
    state_f, vol = taf_update_leaky_raw(state_f, cnt, tsum, any_ev,
                                        height=height, width=width)
    if fold_output:
        return state_f, vol
    B, H2, WF = vol.shape
    return state_f, vol.view(B, H2, WF // 64, 64)
