"""Spatial sharding of the TAF queue over its rows (counterpart of
frlw_evd_tpu/parallel/spatial.py; SURVEY.md §5: scatter keys are spatially
local, so the (H, W) state shards halo-free).

Shard s of n holds rows [s·H/n, (s+1)·H/n) of every stream's queue. The
events stay global and whole: each shard rebases y into its own rows and
lets the histogram's bounds check drop the foreign events (B1's in
csrc/scatter_hist.cu, `encode/scatter.event_cells` for the others), so the
encode step needs no communication. The one global decision is the
empty-bin freeze: a stream with no event anywhere keeps its queue, and a
shard whose rows saw none ages with the rest of the frame, so each step
passes the flags of the whole frame as `any_events`.

On a process group the shard is the rank (n_shards and shard default to
world() and rank()); on one card a caller runs the n shards one after
another. JAX's 2-D layout (batch halves x H shards, spatial.py:65-71) is
a batch slice of the same call: the state tile, the events and n_valid of
the tile's streams.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..encode.scatter import event_cells
from ..encode.streaming import taf_stream_step
from ..encode.update import taf_stream_step_kernel_p64
from . import dist


def _shard(n_shards: Optional[int], shard: Optional[int], rows: int):
    n = dist.world() if n_shards is None else n_shards
    s = dist.rank() if shard is None else shard
    if not 0 <= s < n or rows % n:
        raise ValueError(f"shard {s} of {n}: {rows} rows do not split into "
                         f"{n} equal shards")
    return n, s, rows // n


def _global_any(xytp, n_valid, height: int, width: int) -> torch.Tensor:
    """(B,) bool: the stream has an event that the unsharded step counts
    (inside n_valid, x, y and p in range as event_cells truncates them)."""
    return event_cells(xytp, n_valid, height, width)[2].any(dim=1)


def _rebased(xytp, y0: int):
    local = xytp.clone()
    local[..., 1] -= y0
    return local


def shard_taf_state(state: torch.Tensor, n_shards: Optional[int] = None,
                    shard: Optional[int] = None) -> torch.Tensor:
    """Shard `shard`'s rows of an unpacked (B, H, W, 2, K) queue, as a
    contiguous copy."""
    _, s, h = _shard(n_shards, shard, state.shape[1])
    return state[:, s * h:(s + 1) * h].contiguous()


def make_spatial_taf_step(height: int, n_shards: Optional[int] = None,
                          shard: Optional[int] = None, *,
                          use_mxu: bool = True):
    """step(state, xytp, n_valid) -> state: `encode/streaming.
    taf_stream_step` on shard `shard`'s (B, H/n, W, 2, K) rows of the
    queue, updated in place; xytp (B, E, 4) f32 events with GLOBAL y,
    n_valid (B,) int32. use_mxu: the histogram in kernel B6 (through
    `scatter_cnt_tsum_mxu`), else the exact `index_add_`."""
    n, s, local_h = _shard(n_shards, shard, height)
    y0 = s * local_h

    def step(state, xytp, n_valid):
        if state.shape[1] != local_h:
            raise ValueError(f"shard state has {state.shape[1]} rows, "
                             f"expected {local_h}")
        n_valid = n_valid.to(xytp.device)
        any_global = _global_any(xytp, n_valid, height, state.shape[2])
        return taf_stream_step(state, _rebased(xytp, y0), n_valid,
                               any_global, use_mxu=use_mxu)

    return step


def shard_taf_state_p64(state_f: torch.Tensor,
                        n_shards: Optional[int] = None,
                        shard: Optional[int] = None) -> torch.Tensor:
    """Shard `shard`'s quarter-rows of a folded p64 queue (B, H/2,
    (W/2)·8K), as a contiguous copy."""
    _, s, h2 = _shard(n_shards, shard, state_f.shape[1])
    return state_f[:, s * h2:(s + 1) * h2].contiguous()


def make_spatial_taf_step_p64(height: int, width: int,
                              n_shards: Optional[int] = None,
                              shard: Optional[int] = None, *,
                              scatter: str = "sorted"):
    """step(state_f, xytp, n_valid) -> (state_f, vol_folded):
    `encode/update.taf_stream_step_kernel_p64` on shard `shard`'s
    (B, H/2/n, (W/2)·8K) quarter-rows, updated in place, and the shard's
    folded bf16 volume. scatter "pallas" is the raw path (kernel B1 in the
    p64 cell order, then B3), "sorted" the plain sorted histogram, then
    B5. xytp carries GLOBAL y."""
    n, s, local_h2 = _shard(n_shards, shard, height // 2)
    y0 = s * local_h2 * 2

    def step(state_f, xytp, n_valid):
        n_valid = n_valid.to(xytp.device)
        any_global = _global_any(xytp, n_valid, height, width)
        return taf_stream_step_kernel_p64(
            state_f, _rebased(xytp, y0), n_valid, any_global,
            height=local_h2 * 2, width=width, scatter=scatter,
            fold_output=True)

    return step
