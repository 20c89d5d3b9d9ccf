// int8 convolution of the int8 serving path: an implicit GEMM on Hopper's
// warpgroup tensor cores (wgmma.mma_async m64nNk32 s8.s8 -> s32), with the
// weights fed by TMA and the activation quantized once, where it arrives.
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
// Design. An implicit GEMM, M output pixels by N = Cout by K = k*k*Cin in
// (tap, channel) order: the NHWC activation and the OHWI weights are both
// K-major, which is what 8-bit wgmma takes (it has no transpose). The
// tiling comes from models/quantize.py::tile_plan. Both kernels are
// persistent (a block an SM walks tiles grid apart) and warp-specialised:
//  - the weights arrive by TMA (cp.async.bulk.tensor over the (Cout, K)
//    int8 matrix, 128- or 64-byte swizzle, rows past Cout zero-filled) in
//    a ring of stages guarded by mbarriers (`full`: the producers' arrivals
//    and the TMA bytes; `empty`: one arrival per consumer warp once its
//    wgmma group has read the stage);
//  - consumer warpgroups hold 64 rows x BN (the site's whole Cout up to
//    256) of s32 sums in registers and issue wgmma with both operands read
//    from shared memory through matrix descriptors, one group in flight;
//  - the activation is read as bf16 and quantized once where it arrives,
//    with no separate quantize pass (it would add 3 bytes an element to the
//    byte-bound sites). int8_conv_wgmma (1x1 sites, and 3x3 ones the halo
//    does not take): producer warpgroups copy each 128-channel K slab
//    AHEAD slabs ahead by cp.async into bf16 staging, zero-filled where a
//    tap pads, and each thread quantizes what it copied into the 128-byte
//    swizzle; BN is all of Cout, so a slab is quantized once per tap and
//    tile, and on 1x1 sites two consumer warpgroups take alternate 64-row
//    tiles so that one's epilogue overlaps the other's products.
//    int8_conv_halo (3x3 sites): the tile's input halo is quantized once
//    for all nine taps and each tap reads it through a shifted descriptor;
//  - the epilogue scales each s32 sum in f32 with separate (uncontracted)
//    multiply and add, rounds to bf16 ties to even, and stores 16 bytes a
//    lane through a warp's shared scratch.
// The codes: x is clamped to [-B, B] in bf16 pairs (code_bits), multiplied
// by inv in f32 and rounded by adding 1.5 * 2^23, which leaves the code in
// the low byte: the clip and round_half_even of the twin, bit for bit.
//
// Bound: the larger of the bytes (one bf16 read of the activation, the
// int8 weights, one bf16 write of the output, at 3.35 TB/s) and the
// products (2 * MACs at 1979 TOP/s). The 3x3 stride-1 sites of 128 or more
// output channels are bound by the products, the 1x1 and stride-2 sites by
// the bytes. What holds each kind back on an H100 is in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int kSlab = 128;          // K bytes a stage (the swizzle's row)
constexpr int kAhead = 2;           // slabs the activation copies run ahead
constexpr int kMaxSmem = 232448;    // per block, H100

struct Conv {
  const uint16_t* x;    // (N, H, W, Cin) bf16 bits
  const float* scale;   // (Cout,) f32
  const float* bias;    // (Cout,) f32 or null
  uint16_t* y;          // (N, Ho, Wo, Cout) bf16 bits
  int32_t* acc;         // (N, Ho, Wo, Cout) int32 or null
  float inv;            // f32(1 / sx)
  uint32_t hi2, lo2;    // (B, B) and (-B, -B) as bf16 pairs (code_bits)
  int N, H, W, Cin, Ho, Wo, Cout, k, stride, pad;
  int M, steps, slabs, stages;  // steps of 32 channels; slabs of 4 steps
  // the halo kernel: its q grid, halo positions a plane, channel blocks
  int Hg, Wg, Ph, cblocks;
};

// round_half_even(f32(x) * inv) as the low byte of the bits, for a bf16
// x already clamped to [-B, B] (`clamp2`), where B is the largest bf16
// with f32(B * inv) < 127.5 (models/quantize.py::clamp_bits): then
// |f32(x * inv)| < 127.5 rounds into [-127, 127], and an x past B rounds
// to +-127 as the clip would (f32(B * inv) > 126.5). Adding 12582912.0f
// (1.5 * 2^23) rounds to the nearest integer, ties to even, and leaves the
// code in the low byte.
__device__ __forceinline__ uint32_t code_bits(float f, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(f, inv), 12582912.0f));
}

// Two bf16 in one word clamped to [lo, hi] (bf16 pairs), one instruction
// each for the min and the max.
__device__ __forceinline__ uint32_t clamp2(uint32_t w, uint32_t hi,
                                           uint32_t lo) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  v = __hmax2(__hmin2(v, *reinterpret_cast<__nv_bfloat162*>(&hi)),
              *reinterpret_cast<__nv_bfloat162*>(&lo));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight bf16 (one 16-byte load) to eight int8 codes (two words).
__device__ __forceinline__ uint2 quantize8(uint4 raw, float inv, uint32_t hi,
                                           uint32_t lo) {
  uint32_t c[8];
  const uint32_t w[4] = {clamp2(raw.x, hi, lo), clamp2(raw.y, hi, lo),
                         clamp2(raw.z, hi, lo), clamp2(raw.w, hi, lo)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[2 * i] = code_bits(__uint_as_float(w[i] << 16), inv);
    c[2 * i + 1] = code_bits(__uint_as_float(w[i] & 0xffff0000u), inv);
  }
  const uint32_t lo8 = __byte_perm(__byte_perm(c[0], c[1], 0x0040),
                                   __byte_perm(c[2], c[3], 0x0040), 0x5410);
  const uint32_t hi8 = __byte_perm(__byte_perm(c[4], c[5], 0x0040),
                                   __byte_perm(c[6], c[7], 0x0040), 0x5410);
  return make_uint2(lo8, hi8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Pins the accumulators around a batch of wgmma, so that the compiler moves
// no other instruction that writes them into the batch (which would make
// ptxas serialize the wgmma).
template <int R>
__device__ __forceinline__ void fence_acc(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (stride byte offset), the atom
// 1024-byte aligned; moving 32 K bytes inside the atom adds 32 to the start
// address (the swizzle acts on the address bits).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The epilogue of a warp's 16 x BN share of a wgmma tile: rows lane / 4
// and lane / 4 + 8 are output pixels m_lo and m_hi (-1: none), columns
// n0 + 8 i + 2 (lane % 4) (+ 1); Cout is a multiple of 8, so a pair, and
// an 8-column group, is in or out whole. f32(acc) * scale (+ bias),
// uncontracted, rounded to bf16. Each 16 x 16 block passes through the
// warp's kEpiRow x 16 bytes of shared `scratch`, so that each lane stores 16
// bytes and each output row's 32 bytes go out in one sector (the fragment's
// own 4-byte pieces, 16 bytes a row a store, halved the write rate).
constexpr int kEpiRow = 48;                 // bytes a scratch row (32 + 16)
constexpr int kEpiBytes = 16 * kEpiRow;     // scratch a consumer warp
template <int BN>
__device__ __forceinline__ void store_tile(const Conv& p, const int32_t* acc,
                                           int m_lo, int m_hi, int n0,
                                           int lane, uint8_t* scratch) {
  const int g = lane >> 2, t = lane & 3;
  const int r = lane >> 1, half = lane & 1;  // the row and 8 columns stored
  const int lo = __shfl_sync(0xffffffffu, m_lo, 4 * (r & 7));
  const int hi = __shfl_sync(0xffffffffu, m_hi, 4 * (r & 7));
  const int m_r = r < 8 ? lo : hi;
#pragma unroll
  for (int j = 0; j < (BN + 15) / 16; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (BN == 8 && b) break;
      const int i = 2 * j + b;
      const int co = n0 + i * 8 + 2 * t;
      // a branch, not a select: the loads then stay where they are used
      // (hoisted, all of BN's would cost registers the sums hold)
      if (co >= p.Cout) continue;
      const float s0 = __ldg(p.scale + co), s1 = __ldg(p.scale + co + 1);
      const float c0 = p.bias ? __ldg(p.bias + co) : 0.0f;
      const float c1 = p.bias ? __ldg(p.bias + co + 1) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = acc[4 * i + 2 * h], q1 = acc[4 * i + 2 * h + 1];
        float o0 = __fmul_rn(__int2float_rn(q0), s0);
        float o1 = __fmul_rn(__int2float_rn(q1), s1);
        if (p.bias) {
          o0 = __fadd_rn(o0, c0);
          o1 = __fadd_rn(o1, c1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            scratch + (g + 8 * h) * kEpiRow + (b * 8 + 2 * t) * 2) =
            __floats2bfloat162_rn(o0, o1);
        const int m = h ? m_hi : m_lo;
        if (p.acc && m >= 0)
          *reinterpret_cast<int2*>(p.acc + (int64_t)m * p.Cout + co) =
              make_int2(q0, q1);
      }
    }
    __syncwarp();
    const int col = n0 + 16 * j + 8 * half;
    if (m_r >= 0 && col < p.Cout && (BN > 8 || !half))
      *reinterpret_cast<uint4*>(p.y + (int64_t)m_r * p.Cout + col) =
          *reinterpret_cast<const uint4*>(scratch + r * kEpiRow + half * 16);
    __syncwarp();
  }
}

// The ring slot of a block's slab g (slab s of its t-th tile, `slabs` a
// tile): stage g % stages in round g / stages; with ping-pong consumers
// each owns half the stages (tile t goes to consumer t % 2), so that a
// stage's rounds are always one consumer's and its parity waits never
// alias a round the other consumer has not yet taken.
template <bool PP>
__device__ __forceinline__ void ring_slot(int t, int s, int slabs, int stages,
                                          int& stage, int& round) {
  if (PP) {
    const int half = stages / 2, l = (t >> 1) * slabs + s;
    stage = (t & 1) * half + l % half;
    round = l / half;
  } else {
    const int g = t * slabs + s;
    stage = g % stages;
    round = g / stages;
  }
}

template <int BN, int NC, int NP, bool PP>
__global__ void __launch_bounds__(128 * (NC + NP), 1)
int8_conv_wgmma(const __grid_constant__ CUtensorMap wmap, const Conv p) {
  constexpr int BM = PP ? 64 : 64 * NC;  // PP: a warpgroup a 64-row tile
  constexpr int kProducers = 128 * NP;
  constexpr int kABytes = BM * kSlab;
  constexpr int kBBytes = BN * kSlab;
  constexpr int kStage = kABytes + kBBytes;
  constexpr int kStaging = BM * 2 * kSlab;  // a slab of bf16 activation
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* staging = smem + p.stages * kStage;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(staging + (kAhead + 1) * kStaging);
  const uint32_t full0 = smem_addr(bars);               // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * p.stages;         // empty[s]: + 8 s
  const int tid = threadIdx.x;
  const int tiles_n = (p.Cout + BN - 1) / BN;
  const int tiles = (p.M + BM - 1) / BM * tiles_n;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, kProducers + 1);
      mbar_init(empty0 + 8 * s, PP ? 4 : 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the same tiles (blockIdx.x, + gridDim.x, ...) and
  // count the same slabs (`it`), which index the ring and its phases.
  if (tid >= 128 * NC) {
    // ---- producer warpgroup: TMA the weights; copy the activation slab
    // kAhead slabs ahead (across tiles too) into bf16 staging (cp.async,
    // zero-filled where a tap pads or a row is past M), then quantize what
    // this same thread copied into the swizzled int8 stage (no barrier
    // among producers). Slab g of this block is slab g % slabs of its
    // tile g / slabs.
    const int pt = tid - 128 * NC;
    const int chunk = pt & 7;                 // 16-byte chunk of the K row
    const int swz = ((pt >> 3) & 7) ^ chunk;  // its place in the swizzle
    constexpr int kRows = BM / (16 * NP);     // rows a thread fills
    const int cin_steps = p.Cin >> 5;
    const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const int total = my_tiles * p.slabs;
    int r_y[kRows], r_x[kRows], r_n[kRows];
    int coords_of = -1;  // the tile whose rows r_* describe
    auto issue = [&](int g) {
      const int t = g / p.slabs, s = g - t * p.slabs;
      if (t != coords_of) {
        coords_of = t;
        const int m0 = (blockIdx.x + t * gridDim.x) / tiles_n * BM;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int m = m0 + (pt >> 3) + 16 * NP * i;
          const int hw = p.Ho * p.Wo;
          const int n = m / hw, r = m - n * hw;
          const int ho = r / p.Wo, wo = r - ho * p.Wo;
          r_n[i] = m < p.M ? n : -1;
          r_y[i] = ho * p.stride - p.pad;
          r_x[i] = wo * p.stride - p.pad;
        }
      }
      // this thread's 16 K bytes of the slab: step kk, channels ci..ci+15
      const int kk = 4 * s + (chunk >> 1);
      const bool k_ok = kk < p.steps;
      const int tap = kk / cin_steps;
      const int ci = (kk - tap * cin_steps) * 32 + (chunk & 1) * 16;
      const int ky = tap / p.k, kx = tap - (tap / p.k) * p.k;
      const uint32_t dst = smem_addr(staging + (g % (kAhead + 1)) * kStaging +
                                     (pt >> 3) * 2 * kSlab + chunk * 32);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int yi = r_y[i] + ky, xi = r_x[i] + kx;
        const bool ok = k_ok && r_n[i] >= 0 && yi >= 0 && yi < p.H &&
                        xi >= 0 && xi < p.W;
        const uint16_t* src =
            ok ? p.x + (((int64_t)r_n[i] * p.H + yi) * p.W + xi) * p.Cin + ci
               : p.x;
        const int bytes = ok ? 16 : 0;  // 0: sixteen zero bytes (code 0)
        const uint32_t d = dst + i * 16 * NP * 2 * kSlab;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                     "l"(src), "r"(bytes)
                     : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                         d + 16),
                     "l"(src + 8), "r"(bytes)
                     : "memory");
      }
    };
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      if (d < total) issue(d);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    for (int g = 0; g < total; ++g) {
      if (g + kAhead < total) issue(g + kAhead);
      asm volatile("cp.async.commit_group;" ::: "memory");
      const int t = g / p.slabs, s = g - t * p.slabs;
      int stage, round;
      ring_slot<PP>(t, s, p.slabs, p.stages, stage, round);
      if (round > 0) mbar_wait(empty0 + 8 * stage, (round - 1) & 1);
      uint8_t* a_tile = smem + stage * kStage;
      if (pt == 0) {
        const int n0 = (blockIdx.x + t * gridDim.x) % tiles_n * BN;
        const uint32_t bar = full0 + 8 * stage;
        mbar_arrive_tx(bar, kBBytes);
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
                smem_addr(a_tile + kABytes)),
            "l"(reinterpret_cast<uint64_t>(&wmap)), "r"(s * kSlab), "r"(n0),
            "r"(bar)
            : "memory");
      }
      // slab g's copies by this thread have landed
      asm volatile("cp.async.wait_group %0;" ::"n"(kAhead) : "memory");
      const uint8_t* src = staging + (g % (kAhead + 1)) * kStaging +
                           (pt >> 3) * 2 * kSlab + chunk * 32;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const uint4* raw =
            reinterpret_cast<const uint4*>(src + i * 16 * NP * 2 * kSlab);
        const uint2 lo = quantize8(raw[0], p.inv, p.hi2, p.lo2);
        const uint2 hi = quantize8(raw[1], p.inv, p.hi2, p.lo2);
        *reinterpret_cast<uint4*>(a_tile + ((pt >> 3) + 16 * NP * i) * kSlab +
                                  swz * 16) =
            make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      // make the generic-proxy stores visible to wgmma (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full0 + 8 * stage);
    }
  } else {
    // ---- consumer warpgroup c: 64 pixels x BN, s32 sums in registers,
    // of the tile's rows 64 c.. (PP: of every NC-th tile, rows 0..63, so
    // that one warpgroup's epilogue overlaps the other's products)
    const int c = tid >> 7;
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int first = PP ? c : 0, step = PP ? NC : 1;
    for (int k = first; blockIdx.x + k * gridDim.x < tiles; k += step) {
      const int tile = blockIdx.x + k * gridDim.x;
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      int32_t acc[BN / 2];  // the tile's first wgmma overwrites it
      int prev = -1;          // the stage of this tile's previous slab
      for (int s = 0; s < p.slabs; ++s) {
        int stage, round;
        ring_slot<PP>(k, s, p.slabs, p.stages, stage, round);
        mbar_wait(full0 + 8 * stage, round & 1);
        const uint32_t a =
            smem_addr(smem + stage * kStage + (PP ? 0 : c * 64 * kSlab));
        const uint32_t b = smem_addr(smem + stage * kStage + kABytes);
        fence_acc<BN / 2>(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaS8<BN>::mma(acc, sw128_desc(a + 32 * kk),
                           sw128_desc(b + 32 * kk), s > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // keep this stage's group in flight; the previous one is done
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // Epilogue (overlaps the producer's next tile)
      const int row = m0 + (PP ? 0 : c * 64) + warp * 16 + (lane >> 2);
      store_tile<BN>(p, acc, row < p.M ? row : -1,
                     row + 8 < p.M ? row + 8 : -1, n0, lane,
                     reinterpret_cast<uint8_t*>(bars + 2 * p.stages) +
                         (tid >> 5) * kEpiBytes);
    }
  }
}

// The same in the 64-byte swizzle (rows of 64 bytes, 8-row atoms 512 bytes
// apart): the weights of a 64-channel halo block.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// Matrix descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, each 128 contiguous bytes (rows 16 bytes apart), `lbo`
// bytes apart along K and `sbo` along M. Any 16-byte aligned start works,
// so a tap's A operand is the halo shifted by whole rows.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The 3x3 sites with Cin % 64 == 0: the activation quantized once for all
// nine taps. With stride 1, output pixels are indexed in the padded raster
// of each image (Hg = H + 2 rows of Wg = W + 2 columns, images stacked):
// output (n, y, x) is q = n Hg Wg + y Wg + x, padded input (n, r, c) lies
// at position n Hg Wg + r Wg + c (r = yi + 1, c = xi + 1), so output q's
// tap (ky, kx) reads position q + ky Wg + kx. With stride 2 the padded
// input splits into four planes by row and column parity (r = 2 i + a,
// c = 2 j + b), each a raster of Hg = (H + 3) / 2 rows of Wg = (W + 3) / 2
// columns indexed as the outputs are (q = n Hg Wg + y Wg + x), and tap
// (ky, kx) reads plane (ky % 2, kx % 2) at q + (ky / 2) Wg + kx / 2. A
// tile of 128 consecutive q (two consumer warpgroups, BN columns) needs
// Ph = 128 + 2 Wg + 2 (stride 1) or 128 + Wg + 1 (stride 2) positions from
// its first q in each plane, for each block of CB input channels (128, or
// 64 where Cin % 128 is 64 or the halo would not fit): the producer warps
// load that halo once (bf16, 16-byte loads, zeros where the padding is)
// and store its codes K-major without swizzle ([16-channel chunk][plane]
// [position][16 bytes], planes PhS positions apart), and each tap's wgmma
// reads it through a descriptor shifted to its plane and offset. The
// weights come by TMA as in int8_conv_wgmma, one CB-byte K slab a (tap,
// channel block), in the CB-byte swizzle. The junk outputs (q in the
// padding rows and columns) are computed and not stored.
template <int BN, int CB, int S>
__global__ void __launch_bounds__(384, 1)
int8_conv_halo(const __grid_constant__ CUtensorMap wmap, const Conv p) {
  constexpr int BM = 128;
  constexpr int kBBytes = BN * CB;
  constexpr int kChunks = CB / 16;  // 16-channel chunks of a block
  constexpr int kPlanes = S * S;
  constexpr int kHaloThreads = 96;  // producer warps 1-3; warp 0 issues TMA
  constexpr int kPer = kHaloThreads / kChunks;  // halo threads a chunk
  constexpr int kU = 8;             // halo positions in flight a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int phs = (p.Ph + 6) / 8 * 8 + 1;  // plane stride, odd: no conflicts
  const int chunk_bytes = kPlanes * phs * 16;
  const int halo_bytes = kChunks * chunk_bytes;
  uint8_t* halo = smem + p.stages * kBBytes;  // two halo stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(halo + 2 * halo_bytes);
  const uint32_t bfull0 = smem_addr(bars);
  const uint32_t bempty0 = bfull0 + 8 * p.stages;
  const uint32_t hfull0 = bempty0 + 8 * p.stages;  // + 8 s, s < 2
  const uint32_t hempty0 = hfull0 + 16;
  const int tid = threadIdx.x, lane = tid & 31;
  const int per_image = p.Hg * p.Wg;
  const int tiles_n = (p.Cout + BN - 1) / BN;
  const int tiles = (p.N * per_image + BM - 1) / BM * tiles_n;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bfull0 + 8 * s, 1);
      mbar_init(bempty0 + 8 * s, 8);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(hfull0 + 8 * s, kHaloThreads);
      mbar_init(hempty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256 && tid < 288) {
    // ---- warp 8: the weights, one TMA a (tile, channel block, tap)
    if (lane == 0) {
      int g = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % tiles_n * BN;
        for (int cb = 0; cb < p.cblocks; ++cb)
          for (int tap = 0; tap < 9; ++tap, ++g) {
            const int stage = g % p.stages;
            if (g >= p.stages)
              mbar_wait(bempty0 + 8 * stage, (g / p.stages - 1) & 1);
            const uint32_t bar = bfull0 + 8 * stage;
            mbar_arrive_tx(bar, kBBytes);
            asm volatile(
                "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
                "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
                    smem_addr(smem + stage * kBBytes)),
                "l"(reinterpret_cast<uint64_t>(&wmap)),
                "r"(tap * p.Cin + cb * CB), "r"(n0), "r"(bar)
                : "memory");
          }
      }
    }
  } else if (tid >= 288) {
    // ---- warps 9-11: the halo, quantized once a (tile, channel block).
    // Thread ht fills chunk ht % kChunks (16 channels) of each plane at
    // positions ht / kChunks, + kPer, ...
    const int ht = tid - 288;
    const int chunk = ht % kChunks;
    int h = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q0 = tile / tiles_n * BM;
      for (int cb = 0; cb < p.cblocks; ++cb, ++h) {
        const int hs = h & 1;
        if (h >= 2) mbar_wait(hempty0 + 8 * hs, (h / 2 - 1) & 1);
        const uint16_t* src0 = p.x + cb * CB + chunk * 16;
        for (int plane = 0; plane < kPlanes; ++plane) {
          uint8_t* dst = halo + hs * halo_bytes + chunk * chunk_bytes +
                         plane * phs * 16;
          const int ra = (plane >> 1) - 1, cb_ = (plane & 1) - 1;
          // grid coordinates of this thread's first position
          int pos = ht / kChunks;
          int n = (q0 + pos) / per_image;
          int r = q0 + pos - n * per_image;
          int i = r / p.Wg, j = r - (r / p.Wg) * p.Wg;
          for (; pos < p.Ph;) {
            uint4 raw[kU][2];
            int at[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              at[u] = pos < p.Ph ? pos * 16 : -1;
              raw[u][0] = raw[u][1] = make_uint4(0, 0, 0, 0);  // code 0
              const int yi = S * i + ra, xi = S * j + cb_;
              if (pos < p.Ph && n < p.N && yi >= 0 && yi < p.H && xi >= 0 &&
                  xi < p.W) {
                const uint4* src = reinterpret_cast<const uint4*>(
                    src0 + (((int64_t)n * p.H + yi) * p.W + xi) * p.Cin);
                raw[u][0] = __ldg(src);
                raw[u][1] = __ldg(src + 1);
              }
              pos += kPer;
              j += kPer;
              while (j >= p.Wg) {
                j -= p.Wg;
                if (++i == p.Hg) {
                  i = 0;
                  ++n;
                }
              }
            }
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              if (at[u] < 0) continue;
              const uint2 lo = quantize8(raw[u][0], p.inv, p.hi2, p.lo2);
              const uint2 hi = quantize8(raw[u][1], p.inv, p.hi2, p.lo2);
              *reinterpret_cast<uint4*>(dst + at[u]) =
                  make_uint4(lo.x, lo.y, hi.x, hi.y);
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(hfull0 + 8 * hs);
      }
    }
  } else if (tid < 256) {
    // ---- consumer warpgroup c: 64 q x BN, s32 sums in registers; after
    // each wgmma group, release the stages the group before it read
    const int c = tid >> 7, warp = (tid >> 5) & 3;
    int g = 0, h = 0, pend_b = -1, pend_h = -1;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      int32_t acc[BN / 2];  // the tile's first wgmma overwrites it
      for (int cb = 0; cb < p.cblocks; ++cb, ++h) {
        const int hs = h & 1;
        mbar_wait(hfull0 + 8 * hs, (h / 2) & 1);
        const uint32_t hbase =
            smem_addr(halo + hs * halo_bytes) + c * 64 * 16;
        for (int tap = 0; tap < 9; ++tap, ++g) {
          const int stage = g % p.stages;
          mbar_wait(bfull0 + 8 * stage, (g / p.stages) & 1);
          const int ky = tap / 3, kx = tap % 3;
          const uint32_t a =
              hbase + (S == 1 ? (ky * p.Wg + kx) * 16
                              : (((ky & 1) * 2 + (kx & 1)) * phs +
                                 (ky >> 1) * p.Wg + (kx >> 1)) * 16);
          const uint32_t b = smem_addr(smem + stage * kBBytes);
          fence_acc<BN / 2>(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < CB / 32; ++kk)
            WgmmaS8<BN>::mma(
                acc, plain_desc(a + 2 * kk * chunk_bytes, chunk_bytes, 128),
                CB == 128 ? sw128_desc(b + 32 * kk) : sw64_desc(b + 32 * kk),
                cb > 0 || tap > 0 || kk > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          if (lane == 0) {
            if (pend_b >= 0) mbar_arrive(bempty0 + 8 * pend_b);
            if (pend_h >= 0) mbar_arrive(hempty0 + 8 * pend_h);
          }
          pend_b = stage;
          pend_h = tap == 8 ? hs : -1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc<BN / 2>(acc);
      if (lane == 0) {
        mbar_arrive(bempty0 + 8 * pend_b);
        if (pend_h >= 0) mbar_arrive(hempty0 + 8 * pend_h);
      }
      pend_b = pend_h = -1;

      int m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + c * 64 + warp * 16 + (lane >> 2) + 8 * e;
        const int n = q / per_image, r = q - n * per_image;
        const int y = r / p.Wg, x = r - (r / p.Wg) * p.Wg;
        m[e] = n < p.N && y < p.Ho && x < p.Wo ? (n * p.Ho + y) * p.Wo + x
                                                : -1;
      }
      store_tile<BN>(p, acc, m[0], m[1], n0, lane,
                     reinterpret_cast<uint8_t*>(bars + 2 * p.stages + 4) +
                         (tid >> 5) * kEpiBytes);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the process already holds
// (the CUDA runtime has loaded it), so the build links no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

bool valid_bn(int bn) {
  return bn == 8 || bn == 16 || bn == 32 || bn == 64 || bn == 128 ||
         bn == 256;
}

template <int BN, int NC, int NP, bool PP>
cudaError_t launch(const CUtensorMap& map, const Conv& p, int grid, int smem,
                   cudaStream_t stream) {
  static bool ready = false;  // the attribute is per kernel; set it once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_wgmma<BN, NC, NP, PP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int8_conv_wgmma<BN, NC, NP, PP><<<grid, 128 * (NC + NP), smem, stream>>>(
      map, p);
  return cudaGetLastError();
}

// The instantiations: a 256-wide tile's 128 s32 sums a thread leave no
// registers for a fourth warpgroup (512 threads get 128 registers each).
template <int NC, int NP, bool PP>
cudaError_t launch_bn(int bn, const CUtensorMap& map, const Conv& p, int grid,
                      int smem, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<8, NC, NP, PP>(map, p, grid, smem, stream);
    case 16: return launch<16, NC, NP, PP>(map, p, grid, smem, stream);
    case 32: return launch<32, NC, NP, PP>(map, p, grid, smem, stream);
    case 64: return launch<64, NC, NP, PP>(map, p, grid, smem, stream);
    case 128: return launch<128, NC, NP, PP>(map, p, grid, smem, stream);
    default:
      if constexpr (NC + NP <= 3)
        return launch<256, NC, NP, PP>(map, p, grid, smem, stream);
      return cudaErrorInvalidValue;
  }
}

template <int BN, int CB, int S>
cudaError_t launch_halo(const CUtensorMap& map, const Conv& p, int grid,
                        int smem, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_halo<BN, CB, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  int8_conv_halo<BN, CB, S><<<grid, 384, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <int CB, int S>
cudaError_t launch_halo_bn(int bn, const CUtensorMap& map, const Conv& p,
                           int grid, int smem, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch_halo<8, CB, S>(map, p, grid, smem, stream);
    case 16: return launch_halo<16, CB, S>(map, p, grid, smem, stream);
    case 32: return launch_halo<32, CB, S>(map, p, grid, smem, stream);
    case 64: return launch_halo<64, CB, S>(map, p, grid, smem, stream);
    case 128: return launch_halo<128, CB, S>(map, p, grid, smem, stream);
    default: return launch_halo<256, CB, S>(map, p, grid, smem, stream);
  }
}

}  // namespace

// The TMA map of the (Cout, K) int8 weight matrix w (OHWI codes, K =
// k*k*Cin bytes a row, 16-byte aligned) in boxes of `slab` K bytes (128,
// or 64 for a 64-channel halo block) x bn rows, in the slab-byte swizzle,
// rows past Cout read as zero; written to `out` (128 bytes of host
// memory). Returns a CUDA error code (cudaErrorInvalidValue if
// cuTensorMapEncodeTiled refuses the map).
extern "C" int int8_conv_weight_map(const void* w, void* out, int Cout, int K,
                                    int bn, int slab) {
  EncodeTiled encode = encode_tiled();
  if (!encode || !valid_bn(bn) || Cout <= 0 || K <= 0 || K % 16 ||
      (uintptr_t)w % 16 || (slab != 64 && slab != 128))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)slab, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult rc = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      slab == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  memcpy(out, &map, sizeof(map));
  return (int)cudaSuccess;
}

// x (N, H, W, Cin) bf16, 16-byte aligned; scale (Cout,) f32; bias (Cout,)
// f32 or null; y (N, Ho, Wo, Cout) bf16; acc (N, Ho, Wo, Cout) int32 or
// null (the sums, for checking); wmap the map of the (Cout, k, k, Cin)
// int8 weights from int8_conv_weight_map at this bn and the plan's slab
// (128 bytes of host memory; null is refused: the kernel reads the
// weights through it alone); inv_bits the bits of f32(1 / sx), clamp_bits
// those of the bf16 B of code_bits (models/quantize.py::clamp_bits). k in
// {1, 3}, stride in {1, 2}, padding (k - 1) / 2, Cin % 32 == 0, Cout % 8 ==
// 0. The
// plan from models/quantize.py::tile_plan: bm 64 or 128, bn a wgmma width
// of 8 to 256, stages >= 2, smem bytes, grid, np producer warpgroups,
// halo: 0, or the channel block (64 or 128, also the weights' slab) of
// int8_conv_halo (k 3, Cin % halo == 0, bm 128), and pp: two consumer
// warpgroups on alternate 64-row tiles (bm 64). Anything
// else returns cudaErrorInvalidValue without launching. Launches on
// `stream`, no sync.
extern "C" int int8_conv2d(const void* x, const void* scale,
                           const void* bias, void* y, void* acc,
                           const void* wmap, int N, int H, int W, int Cin,
                           int Cout, int k, int stride, int inv_bits,
                           int clamp_bits, int bm, int bn, int stages,
                           int smem, int grid, int np, int halo, int pp,
                           void* stream) {
  const int cb = halo ? halo : kSlab;  // the weights' slab
  const int Hg = stride == 1 ? H + 2 : (H + 3) / 2;  // the halo's q grid
  const int Wg = stride == 1 ? W + 2 : (W + 3) / 2;
  const int Ph = stride == 1 ? 128 + 2 * Wg + 2 : 128 + Wg + 1;
  const int halo_smem = 1024 + stages * (bn * cb + 16) +
                        2 * (cb / 16) * stride * stride *
                            ((Ph + 6) / 8 * 8 + 1) * 16 +
                        32 + 8 * kEpiBytes;
  if (!wmap || N < 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 32 || Cout <= 0 ||
      Cout % 8 || (k != 1 && k != 3) || (stride != 1 && stride != 2) ||
      (bm != 64 && bm != 128) || !valid_bn(bn) || stages < 2 || grid < 1 ||
      (np != 1 && np != 2) ||
      ((bm == 128 || pp) && bn == 256 && np == 2) ||
      (pp && (bm != 64 || halo || stages % 2)) ||
      clamp_bits <= 0 || clamp_bits >= 0x7f80 || smem > kMaxSmem ||
      (halo ? k != 3 || (halo != 64 && halo != 128) || Cin % halo ||
                  bm != 128 || smem < halo_smem
            : smem < 1024 + stages * ((bm + bn) * kSlab + 16) +
                         (kAhead + 1) * bm * 2 * kSlab +
                         (pp ? 8 : bm / 16) * kEpiBytes))
    return (int)cudaErrorInvalidValue;
  const int pad = (k - 1) / 2;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int64_t M = (int64_t)N * Ho * Wo;
  const int64_t K = (int64_t)k * k * Cin;
  if ((halo ? (int64_t)N * Hg * Wg : M) > 0x7fffffff - bm ||
      Cout * K > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  Conv p;
  p.x = (const uint16_t*)x;
  p.scale = (const float*)scale;
  p.bias = (const float*)bias;
  p.y = (uint16_t*)y;
  p.acc = (int32_t*)acc;
  uint32_t bits = (uint32_t)inv_bits;
  float inv;
  memcpy(&inv, &bits, sizeof(inv));
  p.inv = inv;
  p.hi2 = (uint32_t)clamp_bits * 0x00010001u;
  p.lo2 = p.hi2 | 0x80008000u;
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
  p.M = (int)M;
  p.steps = (int)(K / 32);
  p.slabs = (p.steps + 3) / 4;
  p.stages = stages;
  p.Hg = Hg;
  p.Wg = Wg;
  p.Ph = Ph;
  p.cblocks = Cin / cb;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t rc =
      halo ? (stride == 1
                  ? (cb == kSlab
                         ? launch_halo_bn<128, 1>(bn, map, p, grid, smem, s)
                         : launch_halo_bn<64, 1>(bn, map, p, grid, smem, s))
                  : (cb == kSlab
                         ? launch_halo_bn<128, 2>(bn, map, p, grid, smem, s)
                         : launch_halo_bn<64, 2>(bn, map, p, grid, smem, s)))
      : pp ? (np == 2 ? launch_bn<2, 2, true>(bn, map, p, grid, smem, s)
                      : launch_bn<2, 1, true>(bn, map, p, grid, smem, s))
      : bm == 128
          ? (np == 2 ? launch_bn<2, 2, false>(bn, map, p, grid, smem, s)
                     : launch_bn<2, 1, false>(bn, map, p, grid, smem, s))
          : (np == 2 ? launch_bn<1, 2, false>(bn, map, p, grid, smem, s)
                     : launch_bn<1, 1, false>(bn, map, p, grid, smem, s));
  return (int)rc;
}
