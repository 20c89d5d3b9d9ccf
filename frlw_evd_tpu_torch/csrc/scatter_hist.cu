// Kernel B1: per-stream event histogram (count and t-sum) for the TAF encode.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_packed_kernel (reached
// through scatter_cnt_tsum_pallas_sorted(precise=False)). The TPU version
// sorts packed (cell, quantised t) keys and accumulates banded one-hot
// matmuls in VMEM because the TPU has no fast scatter; its bands, SMEM flags
// and serial fallback exist only for that. Hopper has fast L2 atomics, so
// this kernel is the direct form of the function: one thread per (stream,
// event) slot decodes the event and adds [1, t - 1] into the zeroed
// (B, P) count and t-sum planes. There is no miss path, so clustered streams
// are exact too, and t is kept exact (the TPU path quantises it to 12 bits
// and rounds it to bf16).
//
// Semantics (frlw_evd_tpu/encode/pallas_update.py:111-119): x, y, p are
// truncated toward zero (as astype(int32) does), so x = -0.5 is cell 0; an
// event counts when e < n_valid[b] and 0 <= x < W, 0 <= y < H, 0 <= p < 2;
// its cell index is (y * W + x) * 2 + p in the folded order (layout 0), or
// (((y >> 1) * (W / 2) + (x >> 1)) * 4 + s) * 2 + p with subpixel
// s = (x & 1) * 2 + (y & 1) in the patchified p64 order of the
// quarter-resolution queue (layout 1, pallas_update.py:338-340). any_ev[b]
// is set to 1 when stream b had at least one counted event (the whole-frame
// freeze flag of kernels B2 and B3).
//
// Bound: bytes. At GEN1 B = 128, E = 16384 it reads 33.6 MB of events and
// the wrapper writes 149.4 MB of zeroed planes; at gen4 B = 128, E = 65536,
// 512x640, 134.2 MB of events and 671.1 MB of planes. The atomics land in
// L2. The real limit is atomic contention on hot cells of clustered streams.
// Counts are exact (f32 atomics on integers below 2^24); the t-sum order
// varies between runs, so sums agree with any other order only to rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter_cnt_tsum_kernel(const float4* __restrict__ xytp,
                                        const int32_t* __restrict__ n_valid,
                                        float* __restrict__ cnt,
                                        float* __restrict__ tsum,
                                        int32_t* __restrict__ any_ev,
                                        int B, int E, int H, int W,
                                        int layout) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * E) return;
  const int b = (int)(i / E);
  const int e = (int)(i - (int64_t)b * E);
  if (e >= n_valid[b]) return;
  const float4 ev = xytp[i];
  const int x = __float2int_rz(ev.x);
  const int y = __float2int_rz(ev.y);
  const int p = __float2int_rz(ev.w);
  if (x < 0 || x >= W || y < 0 || y >= H || p < 0 || p > 1) return;
  const int64_t local =
      layout == 0 ? ((int64_t)y * W + x) * 2 + p
                  : ((((int64_t)(y >> 1) * (W >> 1) + (x >> 1)) * 4 +
                      (x & 1) * 2 + (y & 1)) * 2 + p);
  const int64_t cell = (int64_t)b * H * W * 2 + local;
  atomicAdd(cnt + cell, 1.0f);
  atomicAdd(tsum + cell, ev.z - 1.0f);
  any_ev[b] = 1;  // every writer stores the same value
}

}  // namespace

// xytp (B, E, 4) f32, n_valid (B,) i32; cnt, tsum (B, H*W*2) f32 and
// any_ev (B,) i32 zeroed by the caller; layout 0 (folded) or 1 (p64, H and W
// even; any other value returns cudaErrorInvalidValue without launching).
// Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum(const void* xytp, const void* n_valid,
                                void* cnt, void* tsum, void* any_ev, int B,
                                int E, int H, int W, int layout,
                                void* stream) {
  if (layout != 0 && !(layout == 1 && H % 2 == 0 && W % 2 == 0))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * E;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    scatter_cnt_tsum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float4*)xytp, (const int32_t*)n_valid, (float*)cnt,
        (float*)tsum, (int32_t*)any_ev, B, E, H, W, layout);
  }
  return (int)cudaGetLastError();
}
