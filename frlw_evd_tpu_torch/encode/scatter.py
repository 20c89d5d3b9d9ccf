"""Per-stream event histogram, kernel B1 (counterpart of
frlw_evd_tpu/encode/pallas_scatter.py::scatter_cnt_tsum_pallas_sorted).

`scatter_cnt_tsum` turns padded events into per-cell count and t-sum
planes. For CUDA tensors it launches `csrc/scatter_hist.cu` (one thread per
event slot, f32 atomics); for CPU tensors it runs the plain twin
`scatter_cnt_tsum_plain`. Counts are exact in both. t is kept exact, where
the TPU path quantises it to 12 bits and rounds it to bf16; the t-sums of the
two agree to about cnt * 2.5e-3.

Two cell orders (`layout`): "folded", cell (y*W + x)*2 + p, for the folded
full-resolution queue (pallas_update.py:111-119); and "p64", the patchified
order of the quarter-resolution queue (pallas_update.py:338-340): subpixel
s = (x&1)*2 + (y&1), cell ((y>>1)*(W/2) + (x>>1))*4 + s, index cell*2 + p.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build


LAYOUTS = ("folded", "p64")


def _check_inputs(xytp: torch.Tensor, n_valid: torch.Tensor, height: int,
                  width: int, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "p64" and (height % 2 or width % 2):
        raise ValueError(f"the p64 cell order needs an even sensor, got "
                         f"{height}x{width}")
    if xytp.dim() != 3 or xytp.shape[-1] != 4 or xytp.dtype != torch.float32:
        raise ValueError(f"xytp must be (B, E, 4) float32, got "
                         f"{tuple(xytp.shape)} {xytp.dtype}")
    if n_valid.shape != xytp.shape[:1] or n_valid.dtype != torch.int32:
        raise ValueError(f"n_valid must be (B,) int32, got "
                         f"{tuple(n_valid.shape)} {n_valid.dtype}")
    if n_valid.device != xytp.device:
        raise ValueError(f"xytp on {xytp.device} but n_valid on "
                         f"{n_valid.device}")


def event_cells(xytp: torch.Tensor, n_valid: torch.Tensor, height: int,
                width: int, layout: str = "folded"):
    """(idx, t - 1, valid) of each event slot, as the TAF steps derive them
    (encode/pallas_update.py:111-119, :331-340): x, y, p truncated toward
    zero, valid when inside n_valid and the sensor, idx in `layout`'s cell
    order."""
    E = xytp.shape[1]
    x = xytp[..., 0].to(torch.int32)
    y = xytp[..., 1].to(torch.int32)
    p = xytp[..., 3].to(torch.int32)
    slot = torch.arange(E, device=xytp.device)
    valid = ((slot[None, :] < n_valid[:, None]) & (x >= 0) & (x < width)
             & (y >= 0) & (y < height) & (p >= 0) & (p < 2))
    if layout == "p64":
        s = (x & 1) * 2 + (y & 1)
        idx = (((y >> 1) * (width // 2) + (x >> 1)) * 4 + s) * 2 + p
    else:
        idx = (y * width + x) * 2 + p
    return idx, xytp[..., 2] - 1.0, valid


def scatter_cnt_tsum_plain(xytp: torch.Tensor, n_valid: torch.Tensor, *,
                           height: int, width: int, layout: str = "folded"):
    """Plain-PyTorch twin of kernel B1 (any device): returns
    (cnt, tsum) each (B, H*W*2) f32 and any_ev (B,) int32."""
    _check_inputs(xytp, n_valid, height, width, layout)
    B = xytp.shape[0]
    P = height * width * 2
    idx, tv, valid = event_cells(xytp, n_valid, height, width, layout)
    offs = torch.arange(B, device=xytp.device)[:, None] * P
    flat = torch.where(valid, idx + offs, B * P).reshape(-1)   # B*P: dump bin
    cnt = torch.bincount(flat, minlength=B * P + 1)[:B * P]
    tsum = torch.bincount(flat, weights=(tv * valid).reshape(-1),
                          minlength=B * P + 1)[:B * P]
    return (cnt.to(torch.float32).reshape(B, P),
            tsum.to(torch.float32).reshape(B, P),
            valid.any(dim=1).to(torch.int32))


def scatter_cnt_tsum(xytp: torch.Tensor, n_valid: torch.Tensor, *,
                     height: int, width: int, layout: str = "folded"):
    """Count + t-sum histogram of padded events.

    Args:
      xytp: (B, E, 4) f32 events [x, y, t, p], t normalised to [0, 1].
      n_valid: (B,) int32 number of real events per stream.
      layout: the cell order, "folded" or "p64" (module docstring).
    Returns (cnt, tsum) each (B, H*W*2) f32 in that cell order, and
    any_ev (B,) int32, 1 where the stream had a counted event.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (and
    count the launch in `scatter_cnt_tsum.launches`) or raise.
    """
    if xytp.device.type == "cpu":
        return scatter_cnt_tsum_plain(xytp, n_valid, height=height,
                                      width=width, layout=layout)
    if xytp.device.type != "cuda":
        raise ValueError(f"scatter_cnt_tsum: unsupported device {xytp.device}")
    _check_inputs(xytp, n_valid, height, width, layout)
    if not xytp.is_contiguous() or xytp.data_ptr() % 16:
        raise ValueError("xytp must be contiguous and 16-byte aligned")
    n_valid = n_valid.contiguous()
    B, E, _ = xytp.shape
    P = height * width * 2
    lib = _build.load("scatter_hist")
    fn = lib.scatter_cnt_tsum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cnt = torch.zeros(B, P, dtype=torch.float32, device=xytp.device)
    tsum = torch.zeros(B, P, dtype=torch.float32, device=xytp.device)
    any_ev = torch.zeros(B, dtype=torch.int32, device=xytp.device)
    stream = torch.cuda.current_stream(xytp.device).cuda_stream
    rc = fn(xytp.data_ptr(), n_valid.data_ptr(), cnt.data_ptr(),
            tsum.data_ptr(), any_ev.data_ptr(), B, E, height, width,
            LAYOUTS.index(layout), stream)
    _build.check(rc, "scatter_cnt_tsum")
    scatter_cnt_tsum.launches += 1
    return cnt, tsum, any_ev


scatter_cnt_tsum.launches = 0
