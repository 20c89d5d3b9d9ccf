// Kernel B6: exact-t count + t-sum histogram from a stream sorted by cell.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_pair_kernel (reached
// through scatter_cnt_tsum_pallas_sorted(precise=True)). The TPU version
// pair-sorts (cell, t) outside the kernel, then accumulates banded one-hot
// matmuls of bf16 value columns [1, t_hi, t_lo] in VMEM, with two more band
// levels and a serial fallback for the events a band misses. All of that
// exists because the TPU has no scatter. Here the wrapper sorts as the JAX
// wrapper does (a stable sort by cell, t gathered in that order), and the
// sorted order itself is the reduction: the events of one cell are one
// contiguous run.
//
// One thread per sorted slot. The slot whose cell differs from its
// predecessor's starts a run; its thread walks the run, counts it and sums
// its t in sorted order in f32, and writes that cell's count and t-sum.
// Every other thread returns at once. There are no atomics, so the same
// input gives bit-identical sums launch after launch (kernel B1's atomics
// reorder its f32 adds from run to run). t stays exact f32, where the TPU's
// bf16 hi/lo columns round each addend to about 2^-17 relative. Dropped
// slots carry the sentinel cell `size`, which sorts last and is never
// written; the caller zeroes the planes first, as B1's are.
//
// Bound: bytes. At gen4 B = 128, E = 65536, 655360 cells per stream: the
// sorted (cell, t) pairs, 67.1 MB, and the planes, 671.1 MB written (the
// zero fill and the run writes). A long run (every event of a stream in one
// cell) is walked by one thread serially: E dependent steps, no parallelism
// inside the run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sorted_runs_kernel(const int32_t* __restrict__ idx_s,
                                   const float* __restrict__ t_s,
                                   float* __restrict__ cnt,
                                   float* __restrict__ tsum, int B, int E,
                                   int size) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * E) return;
  const int b = (int)(i / E);
  const int e = (int)(i - (int64_t)b * E);
  const int32_t* row = idx_s + (int64_t)b * E;
  const int32_t c = row[e];
  // the sentinel run is never written; only a run's first slot works
  if (c >= size || (e > 0 && row[e - 1] == c)) return;
  const float* t = t_s + (int64_t)b * E;
  float s = 0.0f;
  int n = 0;
  for (int j = e; j < E && row[j] == c; ++j) {
    s += t[j];
    ++n;
  }
  const int64_t cell = (int64_t)b * size + c;
  cnt[cell] = (float)n;  // exact below 2^24
  tsum[cell] = s;
}

}  // namespace

// idx_s (B, E) i32 sorted ascending along E, every value in [0, size], size
// the sentinel of dropped slots; t_s (B, E) f32 in the same order; cnt, tsum
// (B, size) f32 zeroed by the caller. Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum_sorted_runs(const void* idx_s, const void* t_s,
                                            void* cnt, void* tsum, int B,
                                            int E, int size, void* stream) {
  const int64_t n = (int64_t)B * E;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    sorted_runs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx_s, (const float*)t_s, (float*)cnt, (float*)tsum,
        B, E, size);
  }
  return (int)cudaGetLastError();
}
