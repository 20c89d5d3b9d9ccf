"""Per-stream count + t-sum histograms, kernels B1, B6 and B8 (counterpart
of frlw_evd_tpu/encode/pallas_scatter.py and of
mxu_scatter.scatter_cnt_tsum_sorted).

`scatter_cnt_tsum` (B1) turns padded events into per-cell count and t-sum
planes. For CUDA tensors it launches `csrc/scatter_hist.cu`; for CPU tensors
it runs the plain twin `scatter_cnt_tsum_plain`. Counts are exact in both.
t is kept exact (both sum t - 1 exactly and round once), where the TPU
path quantises it to 12 bits and rounds it to bf16; the t-sums of the two
agree to about cnt * 2.5e-3.

The other three take cell indices, as the JAX functions of the same names
do: idx, tvals, valid (B, E) → (cnt, tsum) each (B, size) f32, a slot
counted when valid and 0 <= idx < size.
- `scatter_cnt_tsum_pallas_sorted` (B6, precise=True only):
  `csrc/scatter_sorted.cu` sums t as integers (LSB 2^-24) with no sort, so
  its sums are bit-reproducible and, on the steps' t - 1, equal to its
  twin's f64 sums rounded once.
- `scatter_cnt_tsum_pallas` (B8): `csrc/scatter_dense.cu`, the same
  cluster tile with a u32 count and an f32 t-sum a cell, for any f32 t.
- `scatter_cnt_tsum_sorted`: plain torch on any device, as the JAX function
  is XLA outside any Pallas kernel; it keeps that function's bf16 rounding
  of t.

B1, B6 and B8 are output-stationary cluster tiles (`csrc/hist_tile.cuh`):
`tile_plan` cuts a stream's cells into the ranges of clusters of blocks,
each block's slice in shared memory, and the kernel writes every output
cell once (no zero fill).

Two cell orders (`layout`): "folded", cell (y*W + x)*2 + p, for the folded
full-resolution queue (pallas_update.py:111-119); and "p64", the patchified
order of the quarter-resolution queue (pallas_update.py:338-340): subpixel
s = (x&1)*2 + (y&1), cell ((y>>1)*(W/2) + (x>>1))*4 + s, index cell*2 + p.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..utils.profiling import span


LAYOUTS = ("folded", "p64")

# Shared memory a block can use on sm_90, the 16-byte any-event flag the
# kernel keeps after its cells (csrc/hist_tile.cuh: kMaxSmem, kFlagBytes),
# and the blocks of a cluster (the portable maximum).
SMEM_PER_BLOCK = 232448
_FLAG_BYTES = 16
CLUSTER = 8
# Bytes a cell takes in shared memory: one u64 holding its count and its
# t-sum as integers (B1, B6), or a u32 count and an f32 t-sum (B8)
# (csrc/hist_tile.cuh: Packed, Dense).
CELL_BYTES = 8
# A cell's count has 17 bits, so one launch of B1 or B6 takes E < 2^17
# slots a stream. The wrappers take any E: past MAX_SLOTS they launch the
# kernel over chunks of at most MAX_SLOTS slots of each stream and add the
# chunks' planes (`_over_slot_chunks`); their twins chunk the same way.
MAX_SLOTS = 2 ** 17 - 1


class TilePlan(NamedTuple):
    """How B1, B6 and B8 cut a stream's cells: `clusters` clusters of `cluster`
    blocks each; the stream's k-th block (rank r of cluster c is k = c *
    cluster + r) owns cells [k * cells, (k + 1) * cells), clipped to the
    stream's size."""
    clusters: int
    cluster: int
    cells: int

    @property
    def smem_bytes(self) -> int:
        return self.cells * CELL_BYTES + _FLAG_BYTES

    def ranges(self, size: int):
        """(start, stop) of each block's cells, in launch order."""
        return [(min(k * self.cells, size), min((k + 1) * self.cells, size))
                for k in range(self.clusters * self.cluster)]

    def describe(self, size: int, streams: int) -> str:
        return (f"{self.clusters} cluster(s) of {self.cluster} blocks a "
                f"stream, grid ({self.clusters * self.cluster}, {streams}), "
                f"{self.cells} cells a block over {size}, "
                f"{self.smem_bytes} B of dynamic shared memory a block")


def tile_plan(size: int, cluster: int = CLUSTER) -> TilePlan:
    """The fewest clusters of `cluster` blocks whose shared memory holds
    `size` cells, the cells spread evenly over their blocks (a multiple of
    4 a block, for 16-byte stores)."""
    if size < 1 or cluster < 1:
        raise ValueError(f"tile_plan: size {size}, cluster {cluster}")
    most = (SMEM_PER_BLOCK - _FLAG_BYTES) // CELL_BYTES // 4 * 4
    clusters = -(-size // (cluster * most))
    cells = -(-size // (clusters * cluster))
    return TilePlan(clusters, cluster, -(-cells // 4) * 4)


def slot_chunks(E: int):
    """(start, stop) of the chunks of at most MAX_SLOTS slots that B1 and
    B6 cut a stream of E slots into, in order; one chunk when E <=
    MAX_SLOTS."""
    return [(lo, min(lo + MAX_SLOTS, E))
            for lo in range(0, max(E, 1), MAX_SLOTS)]


def _over_slot_chunks(hist, slots, n_valid=None):
    """hist(*slots[, n_valid]) on the slots as given when E <= MAX_SLOTS.
    Past that, hist on each chunk of `slot_chunks(E)` (the (B, E, ...)
    slot tensors cut along E and copied contiguous, n_valid shifted to the
    chunk), the count and t-sum planes added in f32 in chunk order and a
    third output (any_ev) or-ed. Counts stay exact; each chunk's t-sum is
    rounded once to f32 before the adds."""
    E = slots[0].shape[1]
    extra = () if n_valid is None else (n_valid,)
    if E <= MAX_SLOTS:
        return hist(*slots, *extra)
    out = None
    for lo, hi in slot_chunks(E):
        part = [s[:, lo:hi].contiguous() for s in slots]
        if n_valid is not None:
            part.append((n_valid - lo).clamp(0, hi - lo).to(torch.int32))
        got = hist(*part)
        if out is None:
            out = list(got)
            continue
        out[0] += got[0]
        out[1] += got[1]
        if len(got) > 2:
            out[2] |= got[2]
    return tuple(out)


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
    (cnt, tsum) each (B, H*W*2) f32 (t - 1 summed in f64, rounded once a
    chunk of MAX_SLOTS slots, as the wrapper launches B1) and any_ev (B,)
    int32."""
    _check_inputs(xytp, n_valid, height, width, layout)
    return _over_slot_chunks(
        lambda ev, nv: _plain_event_histogram(ev, nv, height, width, layout),
        (xytp,), n_valid)


def _plain_event_histogram(xytp, n_valid, height: int, width: int,
                           layout: str):
    B = xytp.shape[0]
    P = height * width * 2
    idx, tv, valid = event_cells(xytp, n_valid, height, width, layout)
    offs = torch.arange(B, device=xytp.device)[:, None] * P
    flat = torch.where(valid, idx + offs, B * P).reshape(-1)   # B*P: dump bin
    cnt = torch.bincount(flat, minlength=B * P + 1)[:B * P]
    tsum = torch.bincount(flat, weights=(tv * valid).double().reshape(-1),
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
    count each launch in `scatter_cnt_tsum.launches`) or raise. The kernel
    writes all three outputs in full (they are allocated empty) and sums
    the t - 1 as integers at LSB 2^-24, exactly for t in [0, 1]. It takes
    E < 2^17 a launch, so past MAX_SLOTS the wrapper launches it once a
    chunk of slots and adds the planes (`_over_slot_chunks`). A counted
    event with |t - 1| >= 2^(21 - ceil(log2 E)) (32 at E = 65536, 16 for a
    chunk of MAX_SLOTS) makes its cell's t-sum NaN.
    """
    if xytp.device.type == "cpu":
        with span("kernel.b1"):
            return scatter_cnt_tsum_plain(xytp, n_valid, height=height,
                                          width=width, layout=layout)
    if xytp.device.type != "cuda":
        raise ValueError(f"scatter_cnt_tsum: unsupported device {xytp.device}")
    _check_inputs(xytp, n_valid, height, width, layout)
    if not xytp.is_contiguous() or xytp.data_ptr() % 16:
        raise ValueError("xytp must be contiguous and 16-byte aligned")
    plan = tile_plan(height * width * 2)
    return _over_slot_chunks(
        lambda ev, nv: _event_histogram(ev, nv, height, width, layout, plan),
        (xytp,), n_valid.contiguous())


def _event_histogram(xytp, n_valid, height: int, width: int, layout: str,
                     plan: TilePlan):
    """Launch kernel B1 on checked CUDA inputs with the tiling `plan`."""
    B, E, _ = xytp.shape
    P = height * width * 2
    cnt = torch.empty(B, P, dtype=torch.float32, device=xytp.device)
    tsum = torch.empty(B, P, dtype=torch.float32, device=xytp.device)
    any_ev = torch.empty(B, dtype=torch.int32, device=xytp.device)
    with span("kernel.b1"):
        _build.launch("scatter_hist", "scatter_cnt_tsum",
                      (xytp, n_valid, cnt, tsum, any_ev),
                      (B, E, height, width, LAYOUTS.index(layout),
                       plan.clusters, plan.cluster, plan.cells), xytp.device)
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


def _index_add_streams(idx, ok, cols, size: int):
    """(B, size, C) f32: each stream's columns `cols` (B, E, C) of the slots
    `ok` summed into their cells by `index_add_`, the other slots into
    each stream's dump bin."""
    B, C = idx.shape[0], cols.shape[-1]
    acc = torch.zeros(B * (size + 1), C, dtype=torch.float32,
                      device=idx.device)
    acc.index_add_(0, _stream_bins(idx, ok, size), cols.reshape(-1, C))
    return acc.view(B, size + 1, C)[:, :size]


def scatter_cnt_tsum_pallas_sorted_plain(idx, tvals, valid, size: int):
    """Plain-PyTorch twin of kernel B6 (any device): bincount of the
    sentinel-mapped indices, t summed in f64 and rounded once a chunk of
    MAX_SLOTS slots, the chunks' planes added as the wrapper adds B6's."""
    _check_cells(idx, tvals, valid, size)
    return _over_slot_chunks(
        lambda i, t, v: _plain_exact_histogram(i, t, v, size),
        (idx, tvals, valid))


def _plain_exact_histogram(idx, tvals, valid, size: int):
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

    CPU tensors run the plain twin; CUDA tensors launch the kernel (each
    launch counted in `scatter_cnt_tsum_pallas_sorted.launches`) or raise.
    The kernel reads the slots unsorted and sums t as integers at LSB
    2^-24, so two launches agree bit for bit and, where every t is a
    multiple of 2^-24 (as the steps' t - 1 are), the sums equal the twin's.
    It takes E < 2^17 a launch; past MAX_SLOTS the wrapper launches it once
    a chunk of slots and adds the planes in chunk order, as the twin does,
    so the two stay equal bit for bit. A counted t with
    |t| >= 2^(21 - ceil(log2 E)) (32 at E = 65536, 16 for a chunk of
    MAX_SLOTS), or NaN, makes its cell's t-sum NaN.
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
    plan = tile_plan(size)
    return _over_slot_chunks(
        lambda i, t, v: _exact_histogram(i, t, v, size, plan),
        (idx, tvals, valid))


def _exact_histogram(idx, tvals, valid, size: int, plan: TilePlan):
    """Launch kernel B6 on checked CUDA inputs with the tiling `plan`."""
    B, E = idx.shape
    cnt = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    tsum = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    _build.launch("scatter_sorted", "scatter_cnt_tsum_exact",
                  (idx.contiguous(), tvals.contiguous(), valid.contiguous(),
                   cnt, tsum),
                  (B, E, size, plan.clusters, plan.cluster, plan.cells),
                  idx.device)
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
    ok = _kept(idx, valid, size)
    t = torch.where(ok, tvals, 0.0)
    hi = t.to(torch.bfloat16).to(torch.float32)
    cols = [ok.to(torch.float32), hi]
    if precise:
        cols.append((t - hi).to(torch.bfloat16).to(torch.float32))
    acc = _index_add_streams(idx, ok, torch.stack(cols, -1), size)
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
    Returns (cnt, tsum) each (B, size) f32; counts exact, t any f32 (no
    range limit), summed in f32.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (counted
    in `scatter_cnt_tsum_pallas.launches`) or raise. The kernel is the
    cluster tile of B1 and B6 with a u32 count and an f32 t-sum a cell
    (`csrc/hist_tile.cuh`: Dense), tiled by `tile_plan`, one launch for any
    E < 2^30. Its f32 adds run in an order that varies between launches,
    so a cell's t-sum agrees with the twin's to cnt^2 * 2^-23 * max|t|.
    """
    if idx.device.type == "cpu":
        return scatter_cnt_tsum_pallas_plain(idx, tvals, valid, size)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_cnt_tsum_pallas: unsupported device "
                         f"{idx.device}")
    _check_cells(idx, tvals, valid, size)
    B, E = idx.shape
    if E >= 2 ** 30:
        raise ValueError(f"scatter_cnt_tsum_pallas: E = {E} slots, the "
                         f"kernel takes E < 2^30")
    plan = tile_plan(size)
    cnt = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    tsum = torch.empty(B, size, dtype=torch.float32, device=idx.device)
    _build.launch("scatter_dense", "scatter_cnt_tsum_dense",
                  (idx.contiguous(), tvals.contiguous(), valid.contiguous(),
                   cnt, tsum),
                  (B, E, size, plan.clusters, plan.cluster, plan.cells),
                  idx.device)
    scatter_cnt_tsum_pallas.launches += 1
    return cnt, tsum


scatter_cnt_tsum_pallas.launches = 0
