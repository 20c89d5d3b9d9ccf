// Kernel B8: dense count + t-sum histogram with the output tile on chip.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_kernel (reached through
// scatter_cnt_tsum_pallas). The TPU version keeps one stream's whole
// (cells/128, 3*128) accumulator in VMEM and walks every event chunk past
// every 256-row tile as one-hot matmuls, with t split into bf16 hi and lo
// columns. Its structure as a function: the output lives on chip, and every
// event visits every tile. Here that is a histogram privatised in shared
// memory: grid (cell tile, stream); each block holds its tile's counts and
// t-sums in shared memory, scans all E slots of its stream with coalesced
// loads, adds the slots that fall in its tile with shared-memory atomics,
// and writes the tile once. There are no global atomics and no zero fill:
// every output cell is written exactly once. t is kept exact (f32 adds);
// their order inside a tile varies between runs, so sums agree with any
// other order only to rounding. A slot counts when valid and 0 <= idx <
// size, as the TPU wrapper masks it.
//
// Bound: bytes. At GEN1 B = 128, E = 16384, 145920 cells per stream: 18.9 MB
// of slots (idx i32, t f32, valid u8) read once and 149.4 MB of planes
// written. Each block reads its stream's slots again, one pass per tile
// (24 tiles at GEN1), out of L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 6144;  // cells per block: 2 x 24 KB of shared memory
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
dense_hist_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ tvals,
                  const uint8_t* __restrict__ valid, float* __restrict__ cnt,
                  float* __restrict__ tsum, int E, int size) {
  __shared__ float s_cnt[kTile];
  __shared__ float s_tsum[kTile];
  const int b = blockIdx.y;
  const int base = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    s_cnt[i] = 0.0f;
    s_tsum[i] = 0.0f;
  }
  __syncthreads();
  const int64_t row = (int64_t)b * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int32_t c = idx[row + e];
    const int local = c - base;
    if (valid[row + e] && c >= 0 && c < size && local >= 0 && local < kTile) {
      atomicAdd(&s_cnt[local], 1.0f);
      atomicAdd(&s_tsum[local], tvals[row + e]);
    }
  }
  __syncthreads();
  const int n = min(kTile, size - base);
  const int64_t out = (int64_t)b * size + base;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cnt[out + i] = s_cnt[i];
    tsum[out + i] = s_tsum[i];
  }
}

}  // namespace

// idx (B, E) i32, tvals (B, E) f32, valid (B, E) u8 (torch.bool); cnt, tsum
// (B, size) f32, every cell written. Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum_dense(const void* idx, const void* tvals,
                                      const void* valid, void* cnt, void* tsum,
                                      int B, int E, int size, void* stream) {
  if (B > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  if (B > 0 && size > 0) {
    const dim3 grid((unsigned)((size + kTile - 1) / kTile), (unsigned)B);
    dense_hist_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const float*)tvals, (const uint8_t*)valid,
        (float*)cnt, (float*)tsum, E, size);
  }
  return (int)cudaGetLastError();
}
