// Kernel B8: dense count + t-sum histogram of cell indices, any f32 t.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_kernel (reached through
// scatter_cnt_tsum_pallas). The TPU version keeps one stream's whole
// (cells/128, 3*128) accumulator in VMEM and walks every event chunk past
// every 256-row tile as one-hot matmuls, with t split into bf16 hi and lo
// columns summed in f32. Its structure as a function: the output lives on
// chip, t is any f32 (no range limit), and the sums are f32.
//
// Here that is the output-stationary cluster tile of kernels B1 and B6
// (hist_tile.cuh) with the Dense cell: a stream's cells in the shared
// memory of a cluster of 8 blocks (at GEN1 one cluster a stream, 18240
// cells, 146 KB a block), the stream's slots read once per cluster with
// coalesced loads, each counted slot added into the owning block's tile
// through distributed shared memory, and each output cell written once
// with 16-byte stores: no zero fill of device memory, no global atomics,
// no rescan of the slots per tile. A cell is a u32 count and an f32 t-sum
// in one 64-bit word. sm_90 has no native f32 add into shared memory (a
// shared f32 reduction compiles to a load and a compare-and-swap loop, and
// a separate count reduction made three remote transactions an add), so
// the lanes of a warp that hit one cell sum their t in registers first
// (reduce_peers) and one lane updates the group's cell with one 64-bit
// compare-and-swap, guessing it empty first: one transaction for a cell's
// first add. The f32 adds of a cell run in an order that varies from
// run to run, so a t-sum agrees with the f64 twin's to f32 rounding
// (cnt^2 * 2^-23 * max|t| of the cell). Unlike B1 and B6, t has no range
// limit and there is no poison bit. A slot counts when valid and
// 0 <= idx < size, as the TPU wrapper masks it.
//
// Bound: bytes. At GEN1 B = 128, E = 16384, 145920 cells per stream: 18.9 MB
// of slots (idx i32, t f32, valid u8) read once and 149.4 MB of planes
// written once, 0.050 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_tile.cuh"

// idx (B, E) i32, tvals (B, E) f32, valid (B, E) u8 (torch.bool); cnt, tsum
// (B, size) f32, every cell written. Tiling: `clusters` clusters of `cs`
// blocks per stream, `cells` cells a block (encode/scatter.py::tile_plan).
// E < 2^30. Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum_dense(const void* idx, const void* tvals,
                                      const void* valid, void* cnt, void* tsum,
                                      int B, int E, int size, int clusters,
                                      int cs, int cells, void* stream) {
  const hist_tile::CellFront front{(const int32_t*)idx, (const float*)tvals,
                                   (const uint8_t*)valid, E, size};
  return hist_tile::launch<hist_tile::CellFront, hist_tile::Dense>(
      front, cnt, tsum, nullptr, B, E, size, clusters, cs, cells,
      (cudaStream_t)stream);
}
