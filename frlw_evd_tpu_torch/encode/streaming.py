"""Batched streaming encoders with state carry (counterpart of
frlw_evd_tpu/encode/streaming.py; reference data/sparse_ops.py).

Every window they take one padded event slice per stream, (B, E, 4) with
n_valid (B,), and update a carried state on the device:

  * event_volume_stream: incremental Event Volume, (B, H, W, bins, 2)
    state with channel 1 - p; the first call splats into every bin, later
    calls shift one bin out and splat the new slice into the last two;
  * event_frame_stream: stateless binary occupancy, 255 in both channels;
  * taf_stream_step: the unpacked TAF queue (B, H, W, 2, K), slot K - 1 the
    newest; taf_stream_step_packed on the network-order (B, H, W, 2K)
    queue (channel c = 2*age + p, newest first); taf_stream_step_folded on
    the same queue folded to (B, H, W*2K);
  * sae_stream: decayed last-timestamp surface with memory carry.

The TAF steps update their state IN PLACE (the JAX pipelines donate it) and
return it; the folded step's update is kernel B2's. Their histograms:
`scatter_cnt_tsum_mxu` (kernel B6 on the card), `scatter_cnt_tsum_sorted`,
kernel B1 (scatter="pallas" with precise=False, the folded cell order),
kernel B6 (scatter="pallas" with precise=True) or an exact `index_add_`
("xla", use_mxu=False). The
streaming functions mask every bound of the TAF and SAE slots (x, y, p);
the event volume and the frame mask n_valid only, as in JAX, and drop a
cell index outside the grid (JAX wraps a negative one).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .mxu_scatter import (scatter_add_mxu, scatter_cnt_tsum_mxu,
                          segment_last_sorted)
from .scatter import (_index_add_streams, event_cells,
                      scatter_cnt_tsum_sorted)
from .sae import LAMDAS
from .update import SCATTERS, _cell_histogram, taf_update_leaky


# ---------------------------------------------------------------------------
# Event Volume (incremental)
# ---------------------------------------------------------------------------

class EVState(NamedTuple):
    volume: torch.Tensor  # (B, H, W, bins, 2) accumulated splats


def ev_init_state(batch, height, width, bins=5, *, device="cuda") -> EVState:
    return EVState(torch.zeros((batch, height, width, bins, 2),
                               dtype=torch.float32, device=device))


def _slots(xytp, n_valid):
    """x, y, t, p of each slot (x, y, p truncated toward zero) and the
    n_valid mask."""
    B, E, _ = xytp.shape
    valid = (torch.arange(E, device=xytp.device)[None, :]
             < n_valid.to(xytp.device)[:, None])
    return (xytp[..., 0].to(torch.int32), xytp[..., 1].to(torch.int32),
            xytp[..., 2], xytp[..., 3].to(torch.int32), valid)


def event_volume_stream(xytp, n_valid, state: Optional[EVState], now, *,
                        height: int, width: int, bins: int = 5,
                        events_window: int = 50000, infer_time: int = 10000,
                        use_mxu: bool = True):
    """One incremental step (streaming.py:45-113).

    xytp: (B, E, 4) raw [x, y, t (µs), p]; now = end of this window (µs).
    First call (state None): full-window splat over all `bins`. Later
    calls: shift one bin out, add the new slice's two-bin splat. A slot
    whose bin k falls outside [0, channels) is dropped. use_mxu adds each
    weight as bf16 hi + lo (`scatter_add_mxu`), else exactly.
    Returns ((B, H, W, 2*bins) /bins*255 volume, state).
    """
    B, E, _ = xytp.shape
    first = state is None
    now = torch.as_tensor(now, dtype=torch.float32, device=xytp.device)
    x, y, t, p, valid = _slots(xytp, n_valid)
    if first:
        t_star = bins * (t - (now - events_window)) / events_window
        channels = bins
    else:
        channels = 2
        t_star = (t - (now - infer_time)) / events_window * bins
    k0 = torch.floor(t_star).to(torch.int32)
    w1 = t_star - k0
    w0 = 1.0 - w1
    P = height * width * channels * 2

    def idx_for(k):
        ok = valid & (k >= 0) & (k < channels)
        c = ((y * width + x) * channels + k) * 2 + (1 - p)
        return torch.where(ok, c, 2 ** 30)

    vf = valid.to(torch.float32)
    idx = torch.cat([idx_for(k0), idx_for(k0 + 1)], 1)
    w = torch.cat([w0 * vf, w1 * vf], 1)
    if use_mxu:
        img = scatter_add_mxu(idx, w, P)
    else:
        img = _index_add_streams(idx, (idx >= 0) & (idx < P), w[..., None],
                                 P)[..., 0]
    new = img.view(B, height, width, channels, 2)
    if first:
        vol = new
    else:
        old = state.volume[..., 1:, :].clone()      # drop the oldest bin
        old[..., -1, :] += new[..., 0, :]
        vol = torch.cat([old, new[..., 1:, :]], -2)
    out = vol.reshape(B, height, width, bins * 2) / bins * 255.0
    return out, EVState(vol)


# ---------------------------------------------------------------------------
# Event frame
# ---------------------------------------------------------------------------

def event_frame_stream(xytp, n_valid, state=None, *, height: int,
                       width: int):
    """Binary occupancy (streaming.py:120-138): any event at a pixel → 255
    in both channels. Stateless; returns ((B, H, W, 2) f32, None)."""
    x, y, _, _, valid = _slots(xytp, n_valid)
    idx = torch.where(valid, y * width + x, 2 ** 30)
    img = scatter_add_mxu(idx, valid.to(torch.float32), height * width)
    img = torch.where(img > 0, 255.0, 0.0).view(-1, height, width)
    return torch.stack([img, img], -1), None


# ---------------------------------------------------------------------------
# TAF
# ---------------------------------------------------------------------------

def _taf_cells(xytp, n_valid, height: int, width: int):
    """(idx, (t - 1) * valid, valid) over the folded cells (y*W + x)*2 + p,
    every bound masked, idx = H*W*2 where not valid (streaming.py:157-167)."""
    idx, tv, valid = event_cells(xytp, n_valid.to(xytp.device), height,
                                 width)
    return (torch.where(valid, idx, height * width * 2), tv * valid, valid)


def _exact_cnt_tsum(idx, tv, valid, size):
    """The exact histogram of "xla" / use_mxu=False: f32 `index_add_` of 1
    and t (streaming.py:178-181)."""
    ok = valid & (idx >= 0) & (idx < size)
    acc = _index_add_streams(
        idx, ok, torch.stack([ok.to(torch.float32), tv], -1), size)
    return acc[..., 0], acc[..., 1]


def _any_flag(has, any_events, B):
    if any_events is None:
        return has.reshape(B, -1).any(dim=1)
    return any_events.to(device=has.device, dtype=torch.bool)


def taf_stream_step(state, xytp, n_valid, any_events=None, *,
                    use_mxu: bool = True, precise: bool = True,
                    use_sorted: bool = False):
    """Batched single-bin TAF queue update on the unpacked (B, H, W, 2, K)
    state (streaming.py:145-192), t normalised to [0, 1] within the bin.
    use_sorted: `scatter_cnt_tsum_sorted`; else use_mxu:
    `scatter_cnt_tsum_mxu` (kernel B6 on the card); else exact
    `index_add_`. any_events: optional (B,) flags replacing the per-stream
    any-event check (spatially sharded callers pass the global one).
    Returns the state, updated IN PLACE."""
    B, H, W, _, K = state.shape
    P = H * W * 2
    idx, tv, valid = _taf_cells(xytp, n_valid, H, W)
    if use_sorted:
        cnt, tsum = scatter_cnt_tsum_sorted(idx, tv, valid, P, precise)
    elif use_mxu:
        cnt, tsum = scatter_cnt_tsum_mxu(idx, tv, valid, P, precise)
    else:
        cnt, tsum = _exact_cnt_tsum(idx, tv, valid, P)
    cnt = cnt.view(B, H, W, 2)
    tmean = tsum.view(B, H, W, 2) / (cnt + 1e-8)
    has = cnt > 0
    shifted = torch.cat([state[..., 1:] - 1.0, tmean[..., None]], -1)
    updated = torch.where(has[..., None], shifted, state - 1.0)
    any_ev = _any_flag(has, any_events, B).view(B, 1, 1, 1, 1)
    return torch.where(any_ev, updated, state, out=state)


def taf_pack_state(state: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2, K) queue → packed (B, H, W, 2K): channel c = 2*age + p,
    age 0 = newest (slot K - 1) (streaming.py:195-200)."""
    B, H, W, _, K = state.shape
    return state.flip(-1).transpose(-1, -2).reshape(B, H, W, 2 * K)


def taf_unpack_state(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of taf_pack_state (streaming.py:203-207)."""
    B, H, W, _ = packed.shape
    return packed.reshape(B, H, W, K, 2).transpose(-1, -2).flip(-1)


PACKED_SCATTERS = ("pallas", "sorted", "mxu", "xla")


def _packed_histogram(xytp, n_valid, height, width, scatter, precise):
    """(cnt, tsum) (B, H*W*2) of the packed and folded steps
    (streaming.py:239-258, :304-310)."""
    if scatter in SCATTERS:                  # B1, B6 or the sorted one
        cnt, tsum, _ = _cell_histogram(xytp, n_valid.to(xytp.device),
                                       height, width, "folded", scatter,
                                       precise)
        return cnt, tsum
    P = height * width * 2
    idx, tv, valid = _taf_cells(xytp, n_valid, height, width)
    if scatter == "mxu":
        return scatter_cnt_tsum_mxu(idx, tv, valid, P, precise)
    return _exact_cnt_tsum(idx, tv, valid, P)


def _check_packed_scatter(step, scatter, allowed):
    if scatter not in allowed:
        raise ValueError(f"{step} supports scatter {allowed}, got "
                         f"{scatter!r}")


def taf_stream_step_packed(state, xytp, n_valid, any_events=None, *,
                           scatter: str = "mxu", precise: bool = True):
    """Single-bin TAF update on the PACKED (B, H, W, 2K) state
    (streaming.py:210-272): new bin in channels 0:2, survivors shift by 2
    and age by -1; leaky_transform(state) is the network input. scatter
    "pallas" (kernel B1 with precise=False, B6 with precise=True),
    "sorted", "mxu" (B6 on the card) or "xla" (exact). The new mean stays
    f32. Returns the state, updated IN PLACE."""
    _check_packed_scatter("taf_stream_step_packed", scatter, PACKED_SCATTERS)
    B, H, W, C = state.shape
    cnt, tsum = _packed_histogram(xytp, n_valid, H, W, scatter, precise)
    cnt = cnt.view(B, H, W, 2)
    tmean = tsum.view(B, H, W, 2) / (cnt + 1e-8)
    has = cnt > 0
    aged = state - 1.0
    shifted = torch.cat([tmean, aged[..., :C - 2]], -1)
    updated = torch.where(has.repeat(1, 1, 1, C // 2), shifted, aged)
    any_ev = _any_flag(has, any_events, B).view(B, 1, 1, 1)
    return torch.where(any_ev, updated, state, out=state)


def taf_stream_step_folded(state_f, xytp, n_valid, any_events=None, *,
                           height: int, width: int, scatter: str = "pallas",
                           precise: bool = False):
    """The packed update on the FOLDED (B, H, W*2K) state
    (streaming.py:275-330), scatter "pallas" (B1, or B6 when precise) or
    "sorted". JAX rounds the new mean to bf16 before it inserts it
    (:312-318), so the update is the one kernel B2 applies
    (`taf_update_leaky`, its twin on CPU tensors), whose volume is
    dropped. Returns the state, updated IN PLACE."""
    _check_packed_scatter("taf_stream_step_folded", scatter, SCATTERS)
    cnt, tsum = _packed_histogram(xytp, n_valid, height, width, scatter,
                                  precise)
    any_ev = _any_flag(cnt > 0, any_events, cnt.shape[0]).to(torch.int32)
    return taf_update_leaky(state_f, cnt, tsum, any_ev, height=height,
                            width=width)[0]


# ---------------------------------------------------------------------------
# SAE
# ---------------------------------------------------------------------------

SAE_IMPLS = ("sorted", "max")


def sae_stream(xytp, n_valid, memory, now, *, height: int, width: int,
               lamdas=LAMDAS, impl: str = "sorted"):
    """Batched decayed last-timestamp surface with memory carry
    (streaming.py:337-395). impl="sorted": the last slot of each cell in
    stream order (`segment_last_sorted` on t - now, bf16 hi + lo); "max":
    a scatter-max of t - now (timestamps are monotone within a window, so
    the two agree). memory None: now - 5e6 everywhere. Every bound is
    masked. Returns ((B, H, W, 2*len(lamdas)) f32 x255 with c = 2*lam + p,
    new memory (B, H, W, 2))."""
    if impl not in SAE_IMPLS:
        raise ValueError(f"sae_stream impl must be one of {SAE_IMPLS}, got "
                         f"{impl!r}")
    B, E, _ = xytp.shape
    dev = xytp.device
    now = torch.as_tensor(now, dtype=torch.float32, device=dev)
    if memory is None:
        memory = torch.full((B, height, width, 2), 0.0, device=dev) \
            + (now - 5_000_000.0)
    x, y, t, p, valid = _slots(xytp, n_valid)
    valid = (valid & (x >= 0) & (x < width) & (y >= 0) & (y < height)
             & (p >= 0) & (p < 2))
    P = height * width * 2
    idx = (y * width + x) * 2 + p
    if impl == "max":
        dt = torch.where(valid, t - now, -math.inf)
        base = torch.full((B, P + 1), -math.inf, device=dev)
        dt_last = base.scatter_reduce(1, torch.where(valid, idx, P).long(),
                                      dt, "amax", include_self=True)[:, :P]
        t_img = torch.where(torch.isfinite(dt_last), now + dt_last,
                            -math.inf)
    else:
        cnt, dt_last = segment_last_sorted(idx, t - now, valid, P)
        t_img = torch.where(cnt > 0, now + dt_last, -math.inf)
    t_img = torch.maximum(t_img.view(B, height, width, 2), memory)
    dt = t_img - now
    ecd = torch.cat([torch.exp(lam * dt) for lam in
                     torch.tensor(lamdas, dtype=torch.float32)], -1)
    return ecd * 255.0, t_img
