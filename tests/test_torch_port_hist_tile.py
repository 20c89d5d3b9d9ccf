"""What kernels B1 and B6 rest on, checked on the CPU.

B1 and B6 (csrc/scatter_hist.cu, csrc/scatter_sorted.cu) are output-
stationary cluster tiles (csrc/hist_tile.cuh) whose tiling is chosen in
Python by `encode.scatter.tile_plan`; the tests here hold that the plan's
cell ranges cover [0, size) exactly once and fit a block's shared memory.

Both keep a cell as one u64 (csrc/hist_tile.cuh: Packed): its count, and
its t-sum as an integer at a least significant bit of 2^-24, rounded once
to f32. The tests here repeat that arithmetic in numpy, packing included,
on the steps' inputs (t - 1 from `event_cells`, t from the synthetic
streams and from the edges of [0, 1]) and hold it equal, bit for bit, to
B6's twin `scatter_cnt_tsum_pallas_sorted_plain` (f64 sums rounded once):
every t - 1 is a multiple of 2^-24, so both sums are exact before that
rounding.
The card tests (tests/test_torch_port_cuda.py) hold the kernel itself to
the twin.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from frlw_evd_tpu_torch import pipeline
from frlw_evd_tpu_torch.encode import scatter
from frlw_evd_tpu_torch.encode.scatter import (
    CELL_BYTES, MAX_SLOTS, SMEM_PER_BLOCK, event_cells,
    scatter_cnt_tsum_pallas_sorted_plain, tile_plan)

GEN1_CELLS = 240 * 304 * 2
GEN4_CELLS = 512 * 640 * 2


@pytest.mark.parametrize("size,cluster,want", [
    (GEN1_CELLS, 8, (1, 18240)),
    (GEN4_CELLS, 8, (3, 27308)),
    (45_001, 8, None),
    (1_000_003, 8, None),
    (7, 8, None),
    (GEN4_CELLS, 4, (6, 27308)),
    (GEN4_CELLS, 1, (23, 28496)),
], ids=["gen1", "gen4", "odd", "odd-large", "tiny", "gen4-cluster4",
        "gen4-per-block"])
def test_tile_plan_covers_every_cell_once(size, cluster, want):
    """The blocks' ranges, in launch order, tile [0, size) with no gap and
    no overlap; each slice is a multiple of 4 cells (16-byte stores) and
    fits a block's shared memory; no cluster is left empty; one cluster
    fewer would not hold the stream."""
    plan = tile_plan(size, cluster)
    ranges = plan.ranges(size)
    assert len(ranges) == plan.clusters * plan.cluster
    covered = np.zeros(size, np.int32)
    for start, stop in ranges:
        assert 0 <= start <= stop <= size
        covered[start:stop] += 1
    assert (covered == 1).all()
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.cells % 4 == 0 and plan.smem_bytes <= SMEM_PER_BLOCK
    span = plan.clusters * plan.cluster * plan.cells
    assert span >= size > span - plan.cluster * plan.cells
    most = (SMEM_PER_BLOCK - scatter._FLAG_BYTES) // CELL_BYTES
    assert (plan.clusters - 1) * plan.cluster * most < size
    if want is not None:
        assert (plan.clusters, plan.cells) == want


def test_tile_plan_refuses_an_empty_stream():
    with pytest.raises(ValueError, match="tile_plan"):
        tile_plan(0)


SUM_BITS = 46


def _packed_histogram(idx, tv, valid, size):
    """The kernels' arithmetic in numpy: per counted slot the u64 addend
    2^46 + round(t * 2^24) (the poison bit instead when |t| reaches the
    limit), added per cell mod 2^64, then the t-sum field sign-extended,
    the count taken above it and the sum rounded once to f32."""
    B, E = idx.shape
    limit = 2.0 ** (21 - int(np.ceil(np.log2(E))))
    ok = valid & (idx >= 0) & (idx < size)
    bad = ~(np.abs(tv) < limit)
    q = np.where(bad, 0.0, np.rint(tv.astype(np.float64) * 2.0 ** 24))
    add = (np.uint64(1) << np.uint64(SUM_BITS)) + q.astype(np.int64).astype(
        np.uint64)
    words = np.zeros((B, size), np.uint64)
    for b in range(B):
        np.add.at(words[b], idx[b][ok[b]], add[b][ok[b]])
        hit = ok[b] & bad[b]
        np.bitwise_or.at(words[b], idx[b][hit], np.uint64(1) << np.uint64(63))
    poisoned = (words >> np.uint64(63)) == 1
    words &= ~(np.uint64(1) << np.uint64(63))
    low = (words & ((np.uint64(1) << np.uint64(SUM_BITS)) - np.uint64(1)))
    sums = low.astype(np.int64)
    sums = np.where(sums >= 2 ** (SUM_BITS - 1), sums - 2 ** SUM_BITS, sums)
    cnt = (words - sums.astype(np.uint64)) >> np.uint64(SUM_BITS)
    tsum = (sums.astype(np.float64) * 2.0 ** -24).astype(np.float32)
    return cnt.astype(np.float32), np.where(poisoned, np.float32(np.nan),
                                            tsum)


def _edge_events(E, sensor, cells_used):
    """Events whose t are 0, 1 and the f32 neighbours of 0.5 and 1, piled
    into `cells_used` pixels of stream 0 (stream 1 uniform over them)."""
    one, half = np.float32(1.0), np.float32(0.5)
    ts = np.array([0.0, 1.0, np.nextafter(half, np.float32(0)), half,
                   np.nextafter(half, one), np.nextafter(one, np.float32(0)),
                   np.nextafter(one, np.float32(2))], np.float32)
    rng = np.random.default_rng(3)
    ev = np.zeros((2, E, 4), np.float32)
    ev[..., 2] = ts[rng.integers(0, len(ts), (2, E))]
    ev[0, :, 0] = rng.integers(0, cells_used, E)
    ev[1, :, 0] = np.arange(E) % cells_used
    ev[..., 3] = rng.integers(0, 2, (2, E))
    return ev, np.array([E, E - 5], np.int32)


@pytest.mark.parametrize("source", ["uniform", "skewed", "edges_one_cell",
                                    "edges_few_cells"])
@pytest.mark.parametrize("layout", ["p64", "folded"])
def test_fixed_point_sum_equals_twin_bit_for_bit(source, layout):
    """On the steps' inputs, the packed integer sum at LSB 2^-24 rounded
    once equals the twin bit for bit. "edges_one_cell" puts all 65536 events
    of a stream in one pixel (per polarity), the largest sum the gen4 step
    makes."""
    sensor = (64, 96)
    if source in ("uniform", "skewed"):
        synth = (pipeline.synth_events if source == "uniform"
                 else pipeline.synth_events_skewed)
        ev, nv = synth(np.random.default_rng(11), 1, 2, 8192, sensor)
        ev, nv = ev[0], nv[0]
    else:
        E = 65536 if source == "edges_one_cell" else 8192
        ev, nv = _edge_events(E, sensor,
                              1 if source == "edges_one_cell" else 5)
    idx, tv, valid = event_cells(torch.from_numpy(ev), torch.from_numpy(nv),
                                 *sensor, layout)
    t_np = tv.numpy()
    assert (t_np.astype(np.float64) * 2.0 ** 24 % 1 == 0).all()
    size = sensor[0] * sensor[1] * 2
    cnt, tsum = _packed_histogram(idx.numpy(), t_np, valid.numpy(), size)
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_sorted_plain(idx, tv, valid,
                                                         size)
    np.testing.assert_array_equal(cnt, p_cnt.numpy())
    np.testing.assert_array_equal(tsum.view(np.int32),
                                  p_tsum.numpy().view(np.int32))
    assert cnt.sum() == int(valid.sum())


def test_packed_fields_hold_the_serving_sums():
    """The addend limit 2^(21 - ceil(log2 E)) admits every t - 1 in [-1, 0]
    for every E a launch takes (E <= MAX_SLOTS = 2^17 - 1: 32 at the gen4
    E = 65536, 16 for a whole chunk), keeps a cell's t-sum field below 2^45
    at LSB 2^-24, and its count below 2^17, clear of the poison bit. The
    wrappers cut longer streams (the JAX fetcher pads to 2^19) into chunks
    that a launch takes."""
    for E in (1, 16384, 65536, MAX_SLOTS):
        limit = 2.0 ** (21 - int(np.ceil(np.log2(E))))
        assert limit >= 1.0 and E * limit * 2.0 ** 24 <= 2.0 ** 45
        assert E < 2 ** 17
    for E in (1, MAX_SLOTS, MAX_SLOTS + 1, 2 ** 17, 2 ** 19, 10 ** 6):
        chunks = scatter.slot_chunks(E)
        assert chunks[0][0] == 0 and chunks[-1][1] == E
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert all(0 < hi - lo <= MAX_SLOTS for lo, hi in chunks)
        assert len(chunks) == -(-E // MAX_SLOTS)


@pytest.mark.parametrize("layout", ["folded", "p64"])
def test_twins_take_more_slots_than_a_launch(layout):
    """Past MAX_SLOTS the twins of B1 and B6 sum chunk by chunk, as the
    wrappers launch the kernels: counts and any_ev equal the one-pass
    histogram's, t-sums within one f32 rounding a chunk, and the two twins
    equal bit for bit. Stream 1 stops inside the third chunk, stream 2 has
    no event; E = 2^18 + 5."""
    H, W = 8, 10
    E = 2 ** 18 + 5
    ev, nv = pipeline.synth_events(np.random.default_rng(3), 1, 3, E, (H, W))
    ev, nv = torch.from_numpy(ev[0]), torch.from_numpy(nv[0])
    nv[1], nv[2] = 2 * MAX_SLOTS + 3, 0
    kw = dict(height=H, width=W, layout=layout)
    cnt, tsum, anyv = scatter.scatter_cnt_tsum_plain(ev, nv, **kw)
    one = scatter._plain_event_histogram(ev, nv, H, W, layout)
    assert torch.equal(cnt, one[0]) and torch.equal(anyv, one[2])
    assert anyv.tolist() == [1, 1, 0]
    assert int(cnt[1].sum()) == 2 * MAX_SLOTS + 3
    ulp = torch.finfo(torch.float32).eps * one[1].abs()
    assert ((tsum - one[1]).abs() <= 3 * ulp).all()
    idx, tv, valid = event_cells(ev, nv, H, W, layout)
    p_cnt, p_tsum = scatter_cnt_tsum_pallas_sorted_plain(idx, tv, valid,
                                                         H * W * 2)
    assert torch.equal(p_cnt, cnt)
    assert torch.equal(p_tsum.view(torch.int32), tsum.view(torch.int32))


def test_packed_poison_marks_only_its_cell():
    """An addend at the limit is counted, not summed, and only its cell's
    t-sum turns NaN (E = 4096: limit 2^9)."""
    idx = np.array([[3, 3, 5, 9] * 1024], np.int32)
    tv = np.full(idx.shape, -0.5, np.float32)
    tv[0, 1] = 2.0 ** 9
    cnt, tsum = _packed_histogram(idx, tv, np.ones(idx.shape, bool), 12)
    assert cnt[0, 3] == 2048 and cnt[0, 5] == cnt[0, 9] == 1024
    assert np.isnan(tsum[0, 3]) and tsum[0, 5] == tsum[0, 9] == -512.0
    assert np.isnan(tsum).sum() == 1


def test_cuda_branches_allocate_empty_outputs():
    """The CUDA branches of B1 and B6 allocate their outputs with
    torch.empty (the kernels write every element) and call no sort: their
    source has no torch.zeros, torch.sort or gather."""
    import inspect

    for fn in (scatter._event_histogram, scatter._exact_histogram):
        src = inspect.getsource(fn)
        assert "torch.empty" in src
        for banned in ("torch.zeros", "torch.sort", "gather", "zero_()"):
            assert banned not in src, f"{fn.__name__} calls {banned}"
