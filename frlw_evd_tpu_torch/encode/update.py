"""Fused TAF queue update + leaky transform, kernel B2 (counterpart of
frlw_evd_tpu/encode/pallas_update.py::taf_update_leaky and
taf_stream_step_kernel).

The TAF queue lives folded as (B, H, W*2K) f32: within each pixel's 2K
block, position c = 2*age + p, newest first. `taf_update_leaky` applies one
bin to it in place from kernel B1's count/t-sum planes and returns the
(B, H, W*2K) bf16 detector volume in [0, 1]. CUDA tensors launch
`csrc/taf_update.cu`; CPU tensors run the plain twin.
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
