"""The histograms of frlw_evd_tpu/encode/mxu_scatter.py, by function.

The JAX functions are XLA, not Pallas: one-hot matmuls that keep the TPU's
scatter loop off the hot path. The matmul is a trick for the MXU and is not
carried over; what is carried over is the function, with JAX's rounding of
each addend to bf16 hi (+ bf16 lo) before the f32 sums:

- `scatter_add_mxu`: dense[idx] += bf16(v) + bf16(v - bf16(v)), the two
  columns summed apart in f32 and added (:61-81); `index_add_` on any
  device.
- `scatter_cnt_tsum_mxu`: the count + value-sum histogram (:85-109). It is
  the function of kernel B6, so after JAX's rounding of the addends it
  launches B6 (`scatter_cnt_tsum_pallas_sorted`) on CUDA tensors and runs
  B6's twin on CPU tensors. B6 sums exactly (integers at LSB 2^-24) where
  JAX sums the hi and lo columns apart in f32: the two agree to f32
  rounding of the sums.
- `segment_last_sorted`: per cell the value of the last valid slot in
  stream order, carried as bf16 hi + bf16 lo (:188-259); a stable
  `torch.sort` by cell and a segment-end mask on any device.
"""

from __future__ import annotations

import torch

from .scatter import (_check_cells, _index_add_streams, _kept, _stream_bins,
                      scatter_cnt_tsum_pallas_sorted, slot_chunks)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _hi_lo(v: torch.Tensor):
    """JAX's split of an f32 value into bf16 hi and bf16 lo."""
    hi = _bf16(v)
    return hi, _bf16(v - hi)


def _as_streams(idx, *rest):
    """(E,) inputs as one stream of (1, E); (B, E) as they are."""
    if idx.dim() == 1:
        return True, (idx[None],) + tuple(r[None] for r in rest)
    return False, (idx,) + rest


def scatter_add_mxu(idx: torch.Tensor, vals: torch.Tensor,
                    size: int) -> torch.Tensor:
    """(size,) f32 with dense[idx[e]] += vals[e] (mxu_scatter.py:61-81);
    idx (E,) or (B, E) → (size,) or (B, size). Indices outside [0, size)
    are dropped. Each value adds as bf16 hi + bf16 lo, the columns summed
    apart and then added, as JAX sums them."""
    one, (idx, vals) = _as_streams(idx, vals)
    ok = (idx >= 0) & (idx < size)
    hi, lo = _hi_lo(torch.where(ok, vals, 0.0))
    acc = _index_add_streams(idx, ok, torch.stack([hi, lo], -1), size)
    dense = acc[..., 0] + acc[..., 1]
    return dense[0] if one else dense


def _b6_limit(E: int) -> float:
    """B6's bound on |t| for a launch over E slots (csrc/hist_tile.cuh:
    |t| < 2^(21 - ceil(log2 E)), E a chunk of at most MAX_SLOTS)."""
    e = max(hi - lo for lo, hi in slot_chunks(E))
    return 2.0 ** (21 - max(e - 1, 0).bit_length())


def scatter_cnt_tsum_mxu(idx: torch.Tensor, tvals: torch.Tensor,
                         valid: torch.Tensor, size: int,
                         precise: bool = True):
    """Count + value-sum histogram (mxu_scatter.py:85-109): cnt[cell] += 1
    and tsum[cell] += t over the valid slots with 0 <= idx < size. Each t
    adds as bf16(t) + bf16(t - bf16(t)) when precise, else as bf16(t).

    idx (E,) int32, tvals (E,) f32, valid (E,) bool, or all (B, E); returns
    (cnt, tsum) each (size,) or (B, size) f32.

    CUDA tensors launch kernel B6 on the rounded values; CPU tensors run its
    twin. B6 takes |t| < 2^(21 - ceil(log2 E)) (32 at E = 65536): a counted
    value outside that range raises (it would make its cell NaN)."""
    one, (idx, tvals, valid) = _as_streams(idx, tvals, valid)
    _check_cells(idx, tvals, valid, size)
    ok = _kept(idx, valid, size)
    hi, lo = _hi_lo(torch.where(ok, tvals, 0.0))
    t = hi + lo if precise else hi           # exact in f32: 17 bits at most
    if idx.device.type == "cuda":
        limit = _b6_limit(idx.shape[1])
        if bool(((t.abs() >= limit) | ~t.isfinite()).any()):   # one read
            raise ValueError(f"scatter_cnt_tsum_mxu: kernel B6 takes |t| < "
                             f"{limit} at E = {idx.shape[1]} slots, got a "
                             f"counted value outside it")
    cnt, tsum = scatter_cnt_tsum_pallas_sorted(idx, t, ok, size)
    return (cnt[0], tsum[0]) if one else (cnt, tsum)


def segment_last_sorted(idx: torch.Tensor, tvals: torch.Tensor,
                        valid: torch.Tensor, size: int):
    """Per-cell value of the LAST valid slot in stream order
    (mxu_scatter.py:188-259), the `index_put_` semantics of the reference
    SAE scatter.

    idx, tvals, valid: (B, E). Returns (cnt, last) each (B, size) f32: cnt
    the slots a cell counted, last its last slot's value as bf16 hi + bf16
    lo (0 where cnt == 0). The slots are sorted stably by cell, so a
    segment's end is its latest slot even where values are not monotone.
    JAX adds the few slots its sorted bands miss with an unrounded lo
    (:261-285); here every value is rounded, at most 2^-17 of it apart."""
    _check_cells(idx, tvals, valid, size)
    B = idx.shape[0]
    ok = _kept(idx, valid, size)
    key = torch.where(ok, idx, size)
    key_s, order = torch.sort(key, dim=1, stable=True)
    hi, lo = _hi_lo(torch.gather(tvals, 1, order))
    is_end = torch.ones_like(ok)
    is_end[:, :-1] = key_s[:, 1:] != key_s[:, :-1]
    is_end &= key_s < size
    last = torch.zeros(B * (size + 1), dtype=torch.float32,
                       device=idx.device)
    # one slot per cell writes (its segment's end); the rest go to each
    # stream's dump bin
    last.index_put_((_stream_bins(key_s, is_end, size),),
                    (hi + lo).reshape(-1))
    cnt = torch.bincount(_stream_bins(idx, ok, size), minlength=B * (size + 1))
    return (cnt.view(B, size + 1)[:, :size].to(torch.float32).contiguous(),
            last.view(B, size + 1)[:, :size].contiguous())
