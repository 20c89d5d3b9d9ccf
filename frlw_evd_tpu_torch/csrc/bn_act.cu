// The eval epilogue of the detector's conv blocks: BatchNorm, activation
// and an optional residual add, itself optionally gated per sample and
// channel, in one pass over the conv's bf16 output.
//
// It replaces no TPU kernel: the JAX package leaves the BaseConv block
// (blocks.py:177-221) to XLA, which fuses BatchNorm, the activation and
// the add into the conv's epilogue. On the card cuDNN runs the conv and
// torch then ran the eval BatchNorm, the activation and the ResLayers' add
// as three separate passes over the bf16 channels_last output
// (models/epilogue.py has the numbers). Here they are one:
//
//   out = bf16(act((x - mean[c]) * rsqrt(var[c] + eps) * w[c] + b[c])
//              (+ [gate[n, c] *] r))
//
// over x (and r) laid out (pixels, C) with C % 8 == 0, every step in f32
// and one rounding to bf16 at the end. The four parameters are read as
// bf16 or f32 (flags bit 0: mean and var f32; bit 1: weight and bias f32).
// act: 0 silu, 1 relu, 2 leaky relu (slope 0.1), 3 linear (the identity).
// The gate, (N, C) bf16, scales the residual of sample n's pixels: RED's
// SE bottleneck ends in bn(down(x)) + se[n, c] * c3_out, one pass here.
//
// Bound: bytes. x read once, out written once, r read once where there is
// one; at the 1 Mpx stem site (B = 128, 64 x 256 x 320) 1.34 GB each way,
// 0.80 ms at 3.35 TB/s. The gate is N * C * 2 bytes (32 KB at RED's
// largest site) and stays in L1 and L2. The design follows from that:
// - 16-byte loads and stores: a thread owns one group of 8 channels, the
//   block (groups * pixels) threads, so a warp moves 512 contiguous bytes;
// - each thread folds its 8 channels' parameters into a scale and a shift
//   once, in registers (a block's threads share a group's channels, so the
//   groups never change along the grid-stride loop: no shared memory, no
//   per-pixel parameter reads);
// - a grid-stride loop over pixels with a few blocks per SM (the wrapper
//   sizes the grid), two pixels a pass so that two loads per thread are in
//   flight before the first is used;
// - the gate: a thread reads its pixel's sample's 8 gate values as one
//   16-byte load beside r's (the sample index a 32-bit division where
//   the pixels fit 32 bits);
// - the activation and the presence of r and of the gate are template
//   cases, so a case without them compiles to no code for them;
// - no atomics, no host sync, no allocation.
// silu uses the SFU exponential and divide (__expf, __fdividef): their few
// f32 ulps of error lie far below the one bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 256;

enum Act { kSilu = 0, kRelu = 1, kLrelu = 2, kLinear = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kSilu) return __fdividef(v, 1.0f + __expf(-v));
  if (ACT == kRelu) return v < 0.0f ? 0.0f : v;  // NaN passes, as torch
  if (ACT == kLrelu) return v > 0.0f ? v : 0.1f * v;
  return v;
}

__device__ __forceinline__ float param(const void* p, int c, bool f32) {
  return f32 ? static_cast<const float*>(p)[c]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

template <int ACT, bool RES, bool GATE>
__device__ __forceinline__ uint4 apply(uint4 xv, uint4 rv, uint4 gv,
                                       const float* sc, const float* sh) {
  const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t rs[4] = {rv.x, rv.y, rv.z, rv.w};
  const uint32_t gs[4] = {gv.x, gv.y, gv.z, gv.w};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = unpack2(xs[k]);
    float y0 = activate<ACT>(fmaf(a.x, sc[2 * k], sh[2 * k]));
    float y1 = activate<ACT>(fmaf(a.y, sc[2 * k + 1], sh[2 * k + 1]));
    if (GATE) {
      const float2 r = unpack2(rs[k]), gt = unpack2(gs[k]);
      y0 = fmaf(gt.x, r.x, y0);
      y1 = fmaf(gt.y, r.y, y1);
    } else if (RES) {
      const float2 r = unpack2(rs[k]);
      y0 += r.x;
      y1 += r.y;
    }
    o[k] = pack2(y0, y1);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The gate's row of pixel p: its sample, p / hw.
__device__ __forceinline__ int64_t sample_of(int64_t p, int64_t hw,
                                             bool narrow) {
  return narrow ? (int64_t)((uint32_t)p / (uint32_t)hw) : p / hw;
}

template <int ACT, bool RES, bool GATE>
__global__ void __launch_bounds__(kMaxThreads)
    bn_act_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                  const uint4* __restrict__ gate,
                  const void* __restrict__ mean, const void* __restrict__ var,
                  const void* __restrict__ weight,
                  const void* __restrict__ bias, uint4* __restrict__ out,
                  int64_t n_pix, int64_t hw, int groups, int flags,
                  float eps) {
  const int pix_per_block = blockDim.x / groups;  // blockDim: a multiple
  const int lp = threadIdx.x / groups;
  const int g = threadIdx.x - lp * groups;
  const bool stat32 = flags & 1, aff32 = flags & 2;
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = g * 8 + j;
    const float s = param(weight, c, aff32) *
                    rsqrtf(param(var, c, stat32) + eps);
    sc[j] = s;
    sh[j] = param(bias, c, aff32) - param(mean, c, stat32) * s;
  }
  const int64_t stride = (int64_t)gridDim.x * pix_per_block;
  int64_t p = (int64_t)blockIdx.x * pix_per_block + lp;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const bool narrow = n_pix <= 0xffffffffll;
  for (; p + stride < n_pix; p += 2 * stride) {
    const int64_t i0 = p * groups + g, i1 = (p + stride) * groups + g;
    const uint4 x0 = x[i0], x1 = x[i1];
    const uint4 r0 = RES ? res[i0] : zero, r1 = RES ? res[i1] : zero;
    const uint4 g0 =
        GATE ? gate[sample_of(p, hw, narrow) * groups + g] : zero;
    const uint4 g1 =
        GATE ? gate[sample_of(p + stride, hw, narrow) * groups + g] : zero;
    out[i0] = apply<ACT, RES, GATE>(x0, r0, g0, sc, sh);
    out[i1] = apply<ACT, RES, GATE>(x1, r1, g1, sc, sh);
  }
  if (p < n_pix) {
    const int64_t i = p * groups + g;
    out[i] = apply<ACT, RES, GATE>(
        x[i], RES ? res[i] : zero,
        GATE ? gate[sample_of(p, hw, narrow) * groups + g] : zero, sc, sh);
  }
}

template <int ACT, bool RES, bool GATE>
void launch_case(const void* x, const void* res, const void* gate,
                 const void* mean, const void* var, const void* weight,
                 const void* bias, void* out, int64_t n_pix, int64_t hw,
                 int groups, int flags, float eps, int blocks, int threads,
                 cudaStream_t stream) {
  bn_act_kernel<ACT, RES, GATE><<<blocks, threads, 0, stream>>>(
      (const uint4*)x, (const uint4*)res, (const uint4*)gate, mean, var,
      weight, bias, (uint4*)out, n_pix, hw, groups, flags, eps);
}

template <int ACT>
void launch(const void* x, const void* res, const void* gate,
            const void* mean, const void* var, const void* weight,
            const void* bias, void* out, int64_t n_pix, int64_t hw,
            int groups, int flags, float eps, int blocks, int threads,
            cudaStream_t stream) {
  if (gate != nullptr)
    launch_case<ACT, true, true>(x, res, gate, mean, var, weight, bias, out,
                                 n_pix, hw, groups, flags, eps, blocks,
                                 threads, stream);
  else if (res != nullptr)
    launch_case<ACT, true, false>(x, res, nullptr, mean, var, weight, bias,
                                  out, n_pix, hw, groups, flags, eps, blocks,
                                  threads, stream);
  else
    launch_case<ACT, false, false>(x, nullptr, nullptr, mean, var, weight,
                                   bias, out, n_pix, hw, groups, flags, eps,
                                   blocks, threads, stream);
}

}  // namespace

// x, res (nullable), out: (N, H*W, C) bf16, channels last, 16-byte aligned;
// gate (nullable; only with res): (N, C) bf16, 16-byte aligned; mean, var,
// weight, bias: (C,) bf16 or f32 by `flags`; eps_bits: the f32 bits of
// eps. blocks: the grid (the wrapper takes a few per SM, at most one a
// block's pixels); the block is (256 / (C / 8)) * (C / 8) threads.
// Returns cudaErrorInvalidValue without launching for C % 8 != 0,
// C > 2048, an unknown act, a gate without res or blocks < 1.
extern "C" int bn_act(const void* x, const void* res, const void* gate,
                      const void* mean, const void* var, const void* weight,
                      const void* bias, void* out, int N, int HW, int C,
                      int act, int flags, int eps_bits, int blocks,
                      void* stream) {
  const int groups = C / 8;
  if (C % 8 != 0 || groups < 1 || groups > kMaxThreads || act < kSilu ||
      act > kLinear || (gate != nullptr && res == nullptr) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t n_pix = (int64_t)N * HW;
  if (n_pix == 0) return (int)cudaGetLastError();
  float eps;
  memcpy(&eps, &eps_bits, sizeof eps);
  const int threads = (kMaxThreads / groups) * groups;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t hw = HW;
  if (act == kSilu)
    launch<kSilu>(x, res, gate, mean, var, weight, bias, out, n_pix, hw,
                  groups, flags, eps, blocks, threads, s);
  else if (act == kRelu)
    launch<kRelu>(x, res, gate, mean, var, weight, bias, out, n_pix, hw,
                  groups, flags, eps, blocks, threads, s);
  else if (act == kLrelu)
    launch<kLrelu>(x, res, gate, mean, var, weight, bias, out, n_pix, hw,
                   groups, flags, eps, blocks, threads, s);
  else
    launch<kLinear>(x, res, gate, mean, var, weight, bias, out, n_pix, hw,
                    groups, flags, eps, blocks, threads, s);
  return (int)cudaGetLastError();
}
