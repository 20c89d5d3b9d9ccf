"""Per-stream count + t-sum histograms, kernels B1, B6 and B8 (counterpart
of frlw_evd_tpu/encode/pallas_scatter.py and of
mxu_scatter.scatter_cnt_tsum_sorted).

`scatter_cnt_tsum` (B1) turns padded events into per-cell count and t-sum
planes. For CUDA tensors it launches `csrc/scatter_hist.cu` (one thread per
event slot, f32 atomics); for CPU tensors it runs the plain twin
`scatter_cnt_tsum_plain`. Counts are exact in both. t is kept exact, where
the TPU path quantises it to 12 bits and rounds it to bf16; the t-sums of the
two agree to about cnt * 2.5e-3.

The other three take cell indices, as the JAX functions of the same names
do: idx, tvals, valid (B, E) → (cnt, tsum) each (B, size) f32, a slot
counted when valid and 0 <= idx < size.
- `scatter_cnt_tsum_pallas_sorted` (B6, precise=True only): stable sort by
  cell, then `csrc/scatter_sorted.cu` reduces each cell's run with no
  atomics, so its sums are bit-reproducible; t exact.
- `scatter_cnt_tsum_pallas` (B8): `csrc/scatter_dense.cu`, a shared-memory
  tile per block that every slot of its stream visits; t exact.
- `scatter_cnt_tsum_sorted`: plain torch on any device, as the JAX function
  is XLA outside any Pallas kernel; it keeps that function's bf16 rounding
  of t.

Two cell orders (`layout`): "folded", cell (y*W + x)*2 + p, for the folded
full-resolution queue (pallas_update.py:111-119); and "p64", the patchified
order of the quarter-resolution queue (pallas_update.py:338-340): subpixel
s = (x&1)*2 + (y&1), cell ((y>>1)*(W/2) + (x>>1))*4 + s, index cell*2 + p.
"""

from __future__ import annotations

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
    cnt = torch.zeros(B, P, dtype=torch.float32, device=xytp.device)
    tsum = torch.zeros(B, P, dtype=torch.float32, device=xytp.device)
    any_ev = torch.zeros(B, dtype=torch.int32, device=xytp.device)
    _build.launch("scatter_hist", "scatter_cnt_tsum",
                  (xytp, n_valid, cnt, tsum, any_ev),
                  (B, E, height, width, LAYOUTS.index(layout)), xytp.device)
    scatter_cnt_tsum.launches += 1
    return cnt, tsum, any_ev


scatter_cnt_tsum.launches = 0


def _check_cells(idx, tvals, valid, size: int) -> None:
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (B, E) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if tvals.shape != idx.shape or tvals.dtype != torch.float32:
        raise ValueError(f"tvals must be {tuple(idx.shape)} float32, got "
                         f"{tuple(tvals.shape)} {tvals.dtype}")
    if valid.shape != idx.shape or valid.dtype != torch.bool:
        raise ValueError(f"valid must be {tuple(idx.shape)} bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if not 0 < size < 2**31 - 1:
        raise ValueError(f"size must be in [1, 2^31 - 2], got {size}")
    for name, t in (("tvals", tvals), ("valid", valid)):
        if t.device != idx.device:
            raise ValueError(f"idx on {idx.device} but {name} on {t.device}")


def _kept(idx, valid, size: int):
    """The slots that count: valid and inside [0, size)."""
    return valid & (idx >= 0) & (idx < size)


def _stream_bins(idx, ok, size: int):
    """Flat bin of each slot over B streams of size + 1 bins, the last bin
    of a stream taking its dropped slots."""
    B = idx.shape[0]
    offs = torch.arange(B, device=idx.device)[:, None] * (size + 1)
    return (torch.where(ok, idx, size).long() + offs).reshape(-1)


def scatter_cnt_tsum_pallas_sorted_plain(idx, tvals, valid, size: int):
    """Plain-PyTorch twin of kernel B6 (any device): bincount of the
    sentinel-mapped indices, t summed in f64 and rounded once."""
    _check_cells(idx, tvals, valid, size)
    B = idx.shape[0]
    ok = _kept(idx, valid, size)
    flat = _stream_bins(idx, ok, size)
    n = B * (size + 1)
    cnt = torch.bincount(flat, minlength=n).view(B, size + 1)
    tsum = torch.bincount(flat, weights=torch.where(ok, tvals, 0.0).double()
                          .reshape(-1), minlength=n).view(B, size + 1)
    return (cnt[:, :size].to(torch.float32).contiguous(),
            tsum[:, :size].to(torch.float32).contiguous())


def scatter_cnt_tsum_pallas_sorted(idx, tvals, valid, size: int,
                                   precise: bool = True):
    """Exact-t count + t-sum histogram, kernel B6 (pallas_scatter.py:426).

    Args:
      idx, tvals, valid: (B, E) int32 cell indices, f32 values, bool.
      size: cells per stream; invalid or out-of-range slots are dropped.
      precise: must be True. The packed formulation (precise=False) is
        kernel B1, which takes events: call `scatter_cnt_tsum`.
    Returns (cnt, tsum) each (B, size) f32.

    CPU tensors run the plain twin; CUDA tensors sort by cell
    (torch.sort, stable; t gathered in that order, as the JAX wrapper sorts
    outside its kernel) and launch the kernel (counted in
    `scatter_cnt_tsum_pallas_sorted.launches`) or raise.
    """
    if not precise:
        raise ValueError("scatter_cnt_tsum_pallas_sorted takes precise=True "
                         "only: the packed precise=False formulation is "
                         "kernel B1, scatter_cnt_tsum, which takes events")
    if idx.device.type == "cpu":
        return scatter_cnt_tsum_pallas_sorted_plain(idx, tvals, valid, size)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_cnt_tsum_pallas_sorted: unsupported device "
                         f"{idx.device}")
    _check_cells(idx, tvals, valid, size)
    B, E = idx.shape
    key = torch.where(_kept(idx, valid, size), idx, size)  # dropped sort last
    idx_s, order = torch.sort(key, dim=1, stable=True)
    t_s = torch.gather(tvals, 1, order)
    cnt = torch.zeros(B, size, dtype=torch.float32, device=idx.device)
    tsum = torch.zeros(B, size, dtype=torch.float32, device=idx.device)
    _build.launch("scatter_sorted", "scatter_cnt_tsum_sorted_runs",
                  (idx_s, t_s, cnt, tsum), (B, E, size), idx.device)
    scatter_cnt_tsum_pallas_sorted.launches += 1
    return cnt, tsum


scatter_cnt_tsum_pallas_sorted.launches = 0


def scatter_cnt_tsum_sorted(idx, tvals, valid, size: int,
                            precise: bool = True):
    """Count + t-sum histogram with the value rounding of
    mxu_scatter.scatter_cnt_tsum_sorted (:262-330), in plain torch on any
    device: the JAX function is XLA outside any Pallas kernel. Each addend
    of t is bf16(t) when not precise, else bf16(t) + bf16(t - bf16(t)) (its
    one-hot value columns are bf16); the two columns are summed apart in
    f32 and added, as there. The JAX function adds the few events its
    sorted bands miss unrounded (:299-315); here every addend is rounded,
    a difference of at most 2^-9 (2^-17 when precise) per such event.
    Returns (cnt, tsum) each (B, size) f32."""
    _check_cells(idx, tvals, valid, size)
    B = idx.shape[0]
    ok = _kept(idx, valid, size)
    t = torch.where(ok, tvals, 0.0)
    hi = t.to(torch.bfloat16).to(torch.float32)
    cols = [ok.to(torch.float32), hi]
    if precise:
        cols.append((t - hi).to(torch.bfloat16).to(torch.float32))
    acc = torch.zeros(B * (size + 1), len(cols), dtype=torch.float32,
                      device=idx.device)
    acc.index_add_(0, _stream_bins(idx, ok, size),
                   torch.stack(cols, -1).reshape(-1, len(cols)))
    acc = acc.view(B, size + 1, len(cols))[:, :size]
    tsum = acc[..., 1] + acc[..., 2] if precise else acc[..., 1]
    return acc[..., 0].contiguous(), tsum.contiguous()


_LANES = 128


def scatter_cnt_tsum_pallas_plain(idx, tvals, valid, size: int):
    """Plain-PyTorch twin of kernel B8 (any device), from its statement:
    per stream, with cell = hi * 128 + lo, dense[hi, lo] = onehot(hi)^T .
    (onehot(lo) x [1, t]) over the counted slots, in f64, rounded once."""
    _check_cells(idx, tvals, valid, size)
    B, E = idx.shape
    dev = idx.device
    n_hi = -(-size // _LANES)
    ok = _kept(idx, valid, size)
    cell = torch.where(ok, idx, 0).long()
    rows = torch.arange(n_hi, device=dev)
    lanes = torch.arange(_LANES, device=dev)
    cnt = torch.empty(B, n_hi * _LANES, dtype=torch.float32, device=dev)
    tsum = torch.empty_like(cnt)
    for b in range(B):
        onehot_hi = (cell[b, :, None] // _LANES == rows).double()
        onehot_lo = ((cell[b, :, None] % _LANES == lanes)
                     & ok[b, :, None]).double()
        u = torch.cat([onehot_lo, onehot_lo * tvals[b, :, None].double()], 1)
        dense = onehot_hi.T @ u                        # (n_hi, 2 * 128)
        cnt[b] = dense[:, :_LANES].reshape(-1).to(torch.float32)
        tsum[b] = dense[:, _LANES:].reshape(-1).to(torch.float32)
    return cnt[:, :size].contiguous(), tsum[:, :size].contiguous()


def scatter_cnt_tsum_pallas(idx, tvals, valid, size: int):
    """Dense count + t-sum histogram, kernel B8 (pallas_scatter.py:110).

    Args:
      idx, tvals, valid: (B, E) int32 cell indices, f32 values, bool.
      size: cells per stream; invalid or out-of-range slots are dropped.
    Returns (cnt, tsum) each (B, size) f32, t summed exactly in f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (counted
    in `scatter_cnt_tsum_pallas.launches`) or raise.
    """
    if idx.device.type == "cpu":
        return scatter_cnt_tsum_pallas_plain(idx, tvals, valid, size)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_cnt_tsum_pallas: unsupported device "
                         f"{idx.device}")
    _check_cells(idx, tvals, valid, size)
    B, E = idx.shape
    cnt = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    tsum = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    _build.launch("scatter_dense", "scatter_cnt_tsum_dense",
                  (idx.contiguous(), tvals.contiguous(), valid.contiguous(),
                   cnt, tsum), (B, E, size), idx.device)
    scatter_cnt_tsum_pallas.launches += 1
    return cnt, tsum


scatter_cnt_tsum_pallas.launches = 0
