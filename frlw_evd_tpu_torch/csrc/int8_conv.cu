// int8 convolution of the int8 serving path: quantize-on-load implicit GEMM
// on the s8 tensor cores (mma.sync m16n8k32, s32 accumulators).
//
// No TPU Pallas kernel stands behind this one. The JAX package leaves its
// int8 conv to XLA (frlw_evd_tpu/models/quantize.py:283-286,
// lax.conv_general_dilated on int8 codes with preferred_element_type
// int32), which runs it on the TPU's int8 MXU. PyTorch has no int8
// convolution on CUDA (torch._int_mm is a plain matrix product), so the
// port's int8 sites need a kernel of their own.
//
// What it computes, per site (frlw_evd_tpu/models/quantize.py:276-290):
//   xq  = clip(round_half_even(f32(x) * inv), -127, 127)  (inv = f32(1/sx))
//   acc = conv(xq, wq) in int32, stride 1 or 2, zero padding (k-1)/2
//   out = bf16(f32(acc) * scale[c] (+ bias[c]))            (scale = sw*sx)
// on an NHWC (channels_last) bf16 activation, k in {1, 3}, Cin a multiple
// of 32, Cout a multiple of 8. The int32 sums are exact (|acc| <= 127^2 *
// Cin * k^2 < 2^31 at every AED site), so the result is independent of the
// order of the products and equals the f64 twin bit for bit.
//
// Design (a simple kernel that is right; wgmma and TMA are later work):
// an implicit GEMM with M = N*Ho*Wo output pixels, N = Cout, and
// K = k*k*Cin in (tap, channel) order. A block computes a 128-pixel by
// BN-channel tile (BN = 128 where Cout allows, else 64) with 8 warps; each
// k step is one tap and 32 input channels. The activation is read as bf16
// (16-byte loads, 8 channels a load) and quantized while it is moved into
// shared memory, so the path has no separate quantize pass over the
// activation; the weights are pre-packed (Cout, k*k*Cin) int8. Padding
// taps load nothing and store code 0, which is exact for a symmetric
// quantizer. The next step's loads are in registers while the tensor cores
// work on this one (two shared-memory stages, one barrier a step). Shared
// rows are 48 bytes (32 codes + 16 pad), so the fragment loads of a warp
// hit 32 distinct banks. The rounding uses the 1.5 * 2^23 trick: after the
// clip to [-127, 127], adding 12582912.0f rounds to the nearest integer,
// ties to even, and leaves the code in the low byte, with no conversion
// instruction. The epilogue scales each s32 sum in f32 with separate
// (uncontracted) multiply and add and rounds to bf16, ties to even.
//
// Bound: the larger of the bytes (one bf16 read of the activation, the
// int8 weights, one bf16 write of the output, at 3.35 TB/s) and the
// products (2 * MACs at 1979 TOP/s). The 3x3 stride-1 sites of 128 or more
// output channels are bound by the products, the 1x1 and stride-2 sites by
// the bytes; over the GEN1 AED's 61 sites the bytes dominate. This version
// runs far from either (PERF.md): each step quantizes its 128 x 32
// activation tile again (once per tap and per output-channel tile) and
// waits on one barrier for 16 MMAs a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels a block
constexpr int kBK = 32;        // input channels a k step (one tap)
constexpr int kRow = 48;       // bytes a shared row: 32 codes + 16 pad

struct Conv {
  const uint16_t* x;    // (N, H, W, Cin) bf16 bits
  const int8_t* w;      // (Cout, k, k, Cin) int8
  const float* scale;   // (Cout,) f32
  const float* bias;    // (Cout,) f32 or null
  uint16_t* y;          // (N, Ho, Wo, Cout) bf16 bits
  int32_t* acc;         // (N, Ho, Wo, Cout) int32 or null
  float inv;            // f32(1 / sx)
  int N, H, W, Cin, Ho, Wo, Cout, k, stride, pad;
};

// round_half_even(clip(f * inv, -127, 127)) as the low byte of the bits.
__device__ __forceinline__ uint32_t code_bits(float f, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(f, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Eight bf16 (one 16-byte load) to eight int8 codes (two words).
__device__ __forceinline__ uint2 quantize8(uint4 raw, float inv) {
  uint32_t c[8];
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = code_bits(__uint_as_float(w[i] << 16), inv);
    c[2 * i + 1] = code_bits(__uint_as_float(w[i] & 0xffff0000u), inv);
  }
  const uint32_t lo = __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                  __byte_perm(c[2], c[3], 0x0040), 0x5410);
  const uint32_t hi = __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                                  __byte_perm(c[6], c[7], 0x0040), 0x5410);
  return make_uint2(lo, hi);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const Conv p) {
  constexpr int kWarpsN = BN / 32;           // warp tile: (kBM / kWarpsM) x 32
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kMI = kBM / kWarpsM / 16;    // m16 tiles a warp
  constexpr int kNI = 4;                     // n8 tiles a warp
  constexpr int kBChunks = BN / 64;          // 8-byte weight loads a thread
  __shared__ __align__(16) uint8_t sA[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sB[2][BN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int M = p.N * p.Ho * p.Wo;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int K = p.k * p.k * p.Cin;
  const int steps = K / kBK;
  const int cin_steps = p.Cin / kBK;

  // This thread's activation loads: pixels (tid >> 2) + 64 j, channels
  // 8 * (tid & 3) of the step's 32.
  const int part = tid & 3;
  int a_n[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + (tid >> 2) + 64 * j;
    a_ok[j] = m < M;
    const int mm = a_ok[j] ? m : 0;
    const int hw = p.Ho * p.Wo;
    const int n = mm / hw, r = mm - n * hw;
    const int ho = r / p.Wo, wo = r - ho * p.Wo;
    a_n[j] = n;
    a_y[j] = ho * p.stride - p.pad;
    a_x[j] = wo * p.stride - p.pad;
  }
  // This thread's weight loads: rows (tid >> 2) + 64 j, bytes 8 * (tid & 3)
  // (offsets fit an int: Cout * K < 2^31 is checked at launch).
  int b_off[kBChunks];
  bool b_ok[kBChunks];
#pragma unroll
  for (int j = 0; j < kBChunks; ++j) {
    const int co = n0 + (tid >> 2) + 64 * j;
    b_ok[j] = co < p.Cout;
    b_off[j] = (b_ok[j] ? co : 0) * K + part * 8;
  }

  uint4 a_raw[2];
  uint2 b_raw[kBChunks];
  auto load = [&](int s) {
    const int tap = s / cin_steps;
    const int ci = (s - tap * cin_steps) * kBK + part * 8;
    const int ky = tap / p.k, kx = tap - ky * p.k;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int yi = a_y[j] + ky, xi = a_x[j] + kx;
      a_raw[j] = make_uint4(0, 0, 0, 0);  // bf16 zeros: code 0
      if (a_ok[j] && yi >= 0 && yi < p.H && xi >= 0 && xi < p.W)
        a_raw[j] = __ldg(reinterpret_cast<const uint4*>(
            p.x + (((int64_t)a_n[j] * p.H + yi) * p.W + xi) * p.Cin + ci));
    }
#pragma unroll
    for (int j = 0; j < kBChunks; ++j)
      b_raw[j] = b_ok[j] ? __ldg(reinterpret_cast<const uint2*>(
                               p.w + b_off[j] + s * kBK))
                         : make_uint2(0, 0);
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint2*>(&sA[buf][((tid >> 2) + 64 * j) * kRow +
                                         part * 8]) =
          quantize8(a_raw[j], p.inv);
#pragma unroll
    for (int j = 0; j < kBChunks; ++j)
      *reinterpret_cast<uint2*>(&sB[buf][((tid >> 2) + 64 * j) * kRow +
                                         part * 8]) = b_raw[j];
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);
    // all B fragments of the step, then one A fragment at a time (fewer
    // live registers: the 128-channel tile stays under 128 a thread)
    uint32_t b[kNI][2];
#pragma unroll
    for (int j = 0; j < kNI; ++j) {
      const uint8_t* col = &sB[buf][(wn * 32 + j * 8 + g) * kRow];
      b[j][0] = *reinterpret_cast<const uint32_t*>(col + t * 4);
      b[j][1] = *reinterpret_cast<const uint32_t*>(col + 16 + t * 4);
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const uint8_t* row = &sA[buf][(wm * kMI * 16 + i * 16 + g) * kRow];
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(row + t * 4);
      a[1] = *reinterpret_cast<const uint32_t*>(row + 8 * kRow + t * 4);
      a[2] = *reinterpret_cast<const uint32_t*>(row + 16 + t * 4);
      a[3] = *reinterpret_cast<const uint32_t*>(row + 8 * kRow + 16 + t * 4);
#pragma unroll
      for (int j = 0; j < kNI; ++j) mma_s8(acc[i][j], a, b[j]);
    }
    if (s + 1 < steps) stash(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: rows g and g + 8 of each m16 tile, columns 2t and 2t + 1 of
  // each n8 tile; Cout is a multiple of 8, so a pair is in or out whole.
#pragma unroll
  for (int j = 0; j < kNI; ++j) {
    const int co = n0 + wn * 32 + j * 8 + 2 * t;
    if (co >= p.Cout) continue;
    const float s0 = __ldg(p.scale + co), s1 = __ldg(p.scale + co + 1);
    const float c0 = p.bias ? __ldg(p.bias + co) : 0.0f;
    const float c1 = p.bias ? __ldg(p.bias + co + 1) : 0.0f;
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * kMI * 16 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const int q0 = acc[i][j][2 * h], q1 = acc[i][j][2 * h + 1];
        float o0 = __fmul_rn(__int2float_rn(q0), s0);
        float o1 = __fmul_rn(__int2float_rn(q1), s1);
        if (p.bias) {
          o0 = __fadd_rn(o0, c0);
          o1 = __fadd_rn(o1, c1);
        }
        const int64_t at = (int64_t)m * p.Cout + co;
        *reinterpret_cast<__nv_bfloat162*>(p.y + at) =
            __floats2bfloat162_rn(o0, o1);
        if (p.acc) *reinterpret_cast<int2*>(p.acc + at) = make_int2(q0, q1);
      }
  }
}

}  // namespace

// x (N, H, W, Cin) bf16, 16-byte aligned; w (Cout, k, k, Cin) int8; scale
// (Cout,) f32; bias (Cout,) f32 or null; y (N, Ho, Wo, Cout) bf16; acc
// (N, Ho, Wo, Cout) int32 or null (the sums, for checking); inv_bits the
// bits of f32(1 / sx). k in {1, 3}, stride in {1, 2}, padding (k - 1) / 2,
// Cin % 32 == 0, Cout % 8 == 0; anything else returns cudaErrorInvalidValue
// without launching. Launches on `stream`, no sync.
extern "C" int int8_conv2d(const void* x, const void* w, const void* scale,
                           const void* bias, void* y, void* acc, int N, int H,
                           int W, int Cin, int Cout, int k, int stride,
                           int inv_bits, void* stream) {
  if (N < 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % kBK || Cout <= 0 ||
      Cout % 8 || (k != 1 && k != 3) || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int pad = (k - 1) / 2;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int64_t M = (int64_t)N * Ho * Wo;
  if (M > 0x7fffffff - kBM || (int64_t)Cout * k * k * Cin > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  Conv p;
  p.x = (const uint16_t*)x;
  p.w = (const int8_t*)w;
  p.scale = (const float*)scale;
  p.bias = (const float*)bias;
  p.y = (uint16_t*)y;
  p.acc = (int32_t*)acc;
  uint32_t bits = (uint32_t)inv_bits;
  float inv;
  memcpy(&inv, &bits, sizeof(inv));
  p.inv = inv;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Ho = Ho;
  p.Wo = Wo;
  p.Cout = Cout;
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  const unsigned mb = (unsigned)((M + kBM - 1) / kBM);
  if (Cout % 128 == 0)
    int8_conv_kernel<128><<<dim3(mb, Cout / 128), kThreads, 0,
                            (cudaStream_t)stream>>>(p);
  else
    int8_conv_kernel<64><<<dim3(mb, (Cout + 63) / 64), kThreads, 0,
                           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
