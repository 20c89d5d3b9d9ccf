// Kernel B6: exact-t count + t-sum histogram of cell indices, reproducible
// bit for bit, with no sort.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_pair_kernel (reached
// through scatter_cnt_tsum_pallas_sorted(precise=True)). The TPU version
// pair-sorts (cell, t) outside the kernel, then accumulates banded one-hot
// matmuls of bf16 value columns [1, t_hi, t_lo] in VMEM, with two more band
// levels and a serial fallback, because the TPU has no scatter. What it
// promises over kernel B1's TPU form is a sum that does not depend on the
// order of the adds. Here that comes from integers instead of a sort: the
// histogram is an output-stationary cluster tile (hist_tile.cuh) that
// reads the unsorted (idx, t, valid) slots directly and keeps each cell's
// count and t-sum as integers in one u64 (t at a least significant bit of
// 2^-24). Integer adds commute, so every launch gives the same bits,
// whatever the order of the adds.
//
// The sort: gone; the slots are read in their own order. The zero fill:
// gone; the tiles are zeroed in shared memory and each output cell is
// written once. Hot cells: the lanes of a warp that hit one cell are summed
// in registers first, so a stream whose events all fall in one cell costs
// one 64-bit reduction per warp pass, not one serial walk of the run.
//
// Exactness: each t is rounded once to the nearest multiple of 2^-24 (none
// is for the steps' t - 1, which are multiples of 2^-24 already), the sum
// is exact in the integer, and it is rounded once to f32 (__ll2float_rn,
// then an exact scaling by 2^-24). So on the steps' inputs the kernel
// equals its f64 twin bit for bit. Range: E < 2^17, and every counted t
// must satisfy |t| < 2^(21 - ceil(log2 E)) (32 at E = 65536). A t outside
// it, or NaN, is counted but not summed, and its cell's t-sum is written as
// NaN (a poison bit in the cell, visible without a host sync, never a
// silent wrap-around).
//
// Bound: bytes. At gen4 B = 128, E = 65536, 655360 cells per stream: the
// slots (idx i32, t f32, valid u8), 75.5 MB read once, and the two planes,
// 671.1 MB written once: 0.223 ms at 3.35 TB/s. At 8 bytes a cell a stream
// takes 3 clusters of 8 blocks (27308 cells, 218 KB a block); each cluster
// reads the stream's 590 KB of slots, all but the first out of L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_tile.cuh"

namespace {

// Slot e of stream b: counted when valid and 0 <= idx < size.
struct CellFront {
  const int32_t* idx;
  const float* t;
  const uint8_t* valid;
  int E, size;

  __device__ __forceinline__ hist_tile::Slot load(int b, int e, int lo,
                                                  int span, bool*) const {
    hist_tile::Slot s = {-1, 0.0f};
    if (e >= E) return s;
    const int64_t i = (int64_t)b * E + e;
    const int32_t c = __ldg(idx + i);
    if (__ldg(valid + i) && c < size && c >= lo && c - lo < span)
      s.local = c - lo;
    s.t = __ldg(t + i);
    return s;
  }
};

}  // namespace

// idx (B, E) i32, t (B, E) f32, valid (B, E) u8 (torch.bool); cnt, tsum
// (B, size) f32, every cell written. Tiling: `clusters` clusters of `cs`
// blocks per stream, `cells` cells a block (encode/scatter.py::tile_plan).
// E must be below 2^30. Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum_exact(const void* idx, const void* t,
                                      const void* valid, void* cnt, void* tsum,
                                      int B, int E, int size, int clusters,
                                      int cs, int cells, void* stream) {
  const CellFront front{(const int32_t*)idx, (const float*)t,
                        (const uint8_t*)valid, E, size};
  return hist_tile::launch(front, cnt, tsum, nullptr, B, E, size, clusters,
                           cs, cells, (cudaStream_t)stream);
}
