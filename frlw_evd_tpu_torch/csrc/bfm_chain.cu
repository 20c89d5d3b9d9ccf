// Kernels B4 and B7: the BFM stem's per-pixel channel chain on the
// patchified (p64) volume.
//
// B4 replaces frlw_evd_tpu/models/pallas_stem.py::_chain_kernel_folded
// (reached through bfm_chain_apply_folded), B7 replaces ::_stem_chain_kernel
// (reached through bfm_chain_apply). Both read the same bytes, 64 bf16
// channels per quarter-resolution pixel (4 subpixel blocks s of 2K = 16
// queue channels), folded (B, H2, W2*64) or NHWC (B, H2, W2, 64). B4 writes
// 64 channels per pixel, the 48 of h then 16 zeros (so the folded output
// reshapes to NHWC as the TPU stem expects); B7 writes the 48.
//
// Per subpixel block, with bf16 input x (16) and f32 accumulation:
//   y0 = bf16(relu(W0 x + b0))     16 <- 16, 4 groups of 4
//   y1 = bf16(relu(W1 y0 + b1))     8 <- 16, 2 groups of 8
//   y2 = bf16(relu(W2 y1 + b2))     4 <- 8
//   h  = [y0[0:4], y1[0:4], y2[0:4]]                       12
//   a  = bf16(silu(Wu h + bu))                              48 <- 12
//   out = bf16(h + (Wd a + bd))                             12 <- 48
// The weights are the bf16-rounded materialised weight-norm weights (the
// wrapper computes them), the biases f32; these are the TPU kernel's
// rounding points, on which parity depends. The TPU kernel fed its 128-wide
// MXU dense block-diagonal kron(eye) matrices and 0/1 selection and
// placement matmuls; here the grouped structure is computed directly,
// 1312 multiply-adds per subpixel block.
//
// Bound: silu on the special function units. At gen4 B = 128, 512x640
// there are 41.9 M subpixel blocks: 1.342 GB in and 1.342 (B4) or 1.007
// (B7) GB out (0.80 and 0.70 ms at 3.35 TB/s); 110 GFLOP of bf16 products
// (0.11 ms on the tensor cores at 989 TFLOP/s); 2.0 G silu, each an exp2
// and a reciprocal on the SFUs (0.96 ms at 16 per SM per clock). This
// kernel takes the products on the CUDA cores as f32 FMAs (1.6 ms at
// 67 TFLOP/s), a choice of the kernel, not of the function.
//
// One thread per subpixel block reads its 32 contiguous bytes as two
// 16-byte loads. Each block of 256 first copies the 1400 weights (5.6 KB,
// from L2) into shared memory; every weight index is a compile-time
// constant and each row a thread reads is contiguous (trans_down is packed
// transposed), so the weights arrive as 16-byte broadcast loads. Weights in
// __constant__ memory, taken as FMA operands, ran 1.8x slower at this
// shape: the 5.6 KB working set does not fit the SM's constant cache. A
// block that walks several tiles lets the compiler hoist all 1400 weights
// into registers, which spills. No fast-math: silu is v / (1 + expf(-v))
// with IEEE division, which with expf costs about as many instructions as
// the 1312 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// offsets into the weight block, in the order the wrapper packs it; every
// offset is a multiple of 4 floats, so rows load as float4
constexpr int kW0 = 0, kB0 = 64, kW1 = 80, kB1 = 144, kW2 = 152, kB2 = 184,
              kWu = 188, kBu = 764, kWdT = 812, kBd = 1388, kNumWeights = 1400;
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// One subpixel block i: 16 bf16 channels in, 12 out (the 48 of a pixel are
// its 4 blocks). w is the weight block in shared memory.
// OUT_C = 64: 48 channels then 16 zeros per pixel (B4); 48: NHWC (B7)
template <int OUT_C>
__device__ __forceinline__ void chain_subpixel(const float* __restrict__ w,
                                               const uint4* __restrict__ vol,
                                               uint2* __restrict__ out,
                                               int64_t i) {
  float x[16];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 v = vol[2 * i + q];
    const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[8 * q + 2 * k] = bf16_lo(word[k]);
      x[8 * q + 2 * k + 1] = bf16_hi(word[k]);
    }
  }

  float y0[16];
#pragma unroll
  for (int o = 0; o < 16; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = fmaf(w[kW0 + o * 4 + k], x[(o / 4) * 4 + k], acc);
    y0[o] = bf16_round(fmaxf(acc + w[kB0 + o], 0.0f));
  }
  float y1[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = fmaf(w[kW1 + o * 8 + k], y0[(o / 4) * 8 + k], acc);
    y1[o] = bf16_round(fmaxf(acc + w[kB1 + o], 0.0f));
  }
  float h[12];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(w[kW2 + o * 8 + k], y1[k], acc);
    h[o] = y0[o];
    h[4 + o] = y1[o];
    h[8 + o] = bf16_round(fmaxf(acc + w[kB2 + o], 0.0f));
  }

  // trans_up, act and trans_down one hidden channel at a time, so the 48
  // hidden values are never held together
  float d[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) d[j] = 0.0f;
#pragma unroll
  for (int m = 0; m < 48; ++m) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) acc = fmaf(w[kWu + m * 12 + j], h[j], acc);
    const float u = acc + w[kBu + m];
    const float a = bf16_round(u / (1.0f + expf(-u)));
#pragma unroll
    for (int j = 0; j < 12; ++j) d[j] = fmaf(w[kWdT + m * 12 + j], a, d[j]);
  }

  float r[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) r[j] = h[j] + (d[j] + w[kBd + j]);
  const int64_t pix = i >> 2;
  const int s = (int)(i & 3);
  uint2* po = out + pix * (OUT_C / 4) + s * 3;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    po[q] = make_uint2(pack_bf16x2(r[4 * q], r[4 * q + 1]),
                       pack_bf16x2(r[4 * q + 2], r[4 * q + 3]));
  if (OUT_C == 64) out[pix * 16 + 12 + s] = make_uint2(0u, 0u);
}

template <int OUT_C>
__global__ void __launch_bounds__(kThreads)
    bfm_chain_kernel(const uint4* __restrict__ vol,
                     const float4* __restrict__ weights,
                     uint2* __restrict__ out, int64_t n_sub) {
  __shared__ float4 s_w[kNumWeights / 4];
  for (int j = threadIdx.x; j < kNumWeights / 4; j += kThreads)
    s_w[j] = weights[j];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_sub)
    chain_subpixel<OUT_C>(reinterpret_cast<const float*>(s_w), vol, out, i);
}

template <int OUT_C>
int launch(const void* vol, const void* weights, void* out, int B, int H2,
           int W2, void* stream) {
  const int64_t n_sub = (int64_t)B * H2 * W2 * 4;
  if (n_sub > 0) {
    const unsigned blocks = (unsigned)((n_sub + kThreads - 1) / kThreads);
    bfm_chain_kernel<OUT_C><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)vol, (const float4*)weights, (uint2*)out, n_sub);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vol (B, H2, W2*64) bf16, 16-byte aligned; weights (1400,) f32 on the
// device, 16-byte aligned, packed [w0 (16x4), b0, w1 (8x8), b1, w2 (4x8),
// b2, wu (48x12), bu, wd transposed (48x12), bd], each matrix (out, in)
// row-major; out (B, H2, W2*64) bf16, 8-byte aligned. Launches on `stream`,
// no sync.
extern "C" int bfm_chain_apply_folded(const void* vol, const void* weights,
                                      void* out, int B, int H2, int W2,
                                      void* stream) {
  return launch<64>(vol, weights, out, B, H2, W2, stream);
}

// as bfm_chain_apply_folded, but out (B, H2, W2, 48) bf16
extern "C" int bfm_chain_apply(const void* vol, const void* weights, void* out,
                               int B, int H2, int W2, void* stream) {
  return launch<48>(vol, weights, out, B, H2, W2, stream);
}
