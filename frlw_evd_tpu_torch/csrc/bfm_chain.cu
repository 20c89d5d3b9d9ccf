// Kernels B4 and B7: the BFM stem's per-pixel channel chain on the
// patchified (p64) volume, with its five products on the bf16 tensor cores.
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
// The weights are the bf16-rounded materialised weight-norm weights, the
// biases f32; these are the TPU kernel's rounding points, on which parity
// depends.
//
// Bound. At gen4 B = 128, 512x640 there are 41.9 M subpixel blocks: 1.342
// GB in and 1.342 (B4) or 1.007 (B7) GB out (0.80 and 0.70 ms at 3.35
// TB/s); 110 GFLOP of bf16 products (0.11 ms on the tensor cores at 989
// TFLOP/s); 2.0 G silu, each an exp2 and a reciprocal on the special
// function units (0.96 ms at 16 results per SM per clock). So the SFUs
// bound it, then the bytes.
//
// Design. A warp computes a tile of 16 subpixel blocks (4 whole pixels, 512
// contiguous bytes in) as the rows of mma.sync m16n8k16 products (m16n8k8
// for the k = 8 one), bf16 operands and f32 sums, 16 MMAs a tile. The
// grouped convs are padded to dense block-diagonal tiles, as the TPU kernel
// padded them with kron(eye): at this arithmetic intensity that costs
// nothing. Every intermediate stays in registers: the C fragments of two
// adjacent n8 tiles, rounded to bf16 with cvt.rn.bf16x2 (the TPU's rounding
// point), are the A fragment of the next product's k16 step. The wrapper
// (models/stem_chain.py::_pack) permutes the weights so that no shuffle is
// needed:
// - lane (g, t) reads channels 4t..4t+3 of rows g and g + 8 as one 8-byte
//   load each, which the A fragment takes as k = 2t, 2t+1, 2t+8, 2t+9; W0's
//   rows are permuted to match, and a warp's two loads are two whole
//   256-byte lines;
// - y1's columns are rotated by 4, so that y1[0:4] land in columns 4-7 of
//   its C tile, and y2 is computed in columns 0-3 of a tile whose other
//   columns have zero weights and biases. h = [y0[0:4] | y1[0:4] | y2[0:4]]
//   is then each lane's own registers, chosen by t < 2, and trans_down's C
//   tiles hold the same columns, so out = h + (d + bd) is lane-local too.
// trans_up, silu and trans_down run in three k16 chunks of 16 hidden
// channels, so 8 trans_up sums are live at a time. Each lane keeps its B
// fragments (31 words) and biases (24 floats) in registers for the whole
// kernel: the grid holds as many blocks as fit on the SMs at once, and
// their warps walk the tiles with a stride, loading the next tile before
// computing the current one. The output goes through 512 (B4) or 384 (B7)
// bytes of shared memory a warp and leaves as whole 16-byte stores, B4's
// zero pad included (written into shared memory once). A ragged last tile
// is masked per pixel.
//
// silu is u * rcp.approx(1 + ex2.approx(-u log2 e)) (ftz): 2 SFU
// operations and 2 f32 ones, where u / (1 + expf(-u)) with IEEE division,
// the twin's form, takes about 20 instructions. The two differ by a few f32
// ulps before the bf16 rounding of act(u); at gen4 shape the outputs
// stay within atol 1e-2 + rtol 1e-2 of the twin and differ from it at all
// on under 0.02% of values (PERF.md). BFM_CHAIN_SILU_APPROX=0 builds the
// IEEE form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BFM_CHAIN_SILU_APPROX
#define BFM_CHAIN_SILU_APPROX 1
#endif
// Probes for frlw_evd_tpu_torch/kernels/chain_probe.py, 0 in the library:
// 1 makes the activation the identity (no silu), 2 stores the input words
// of each tile in place of the chain (the bytes and the tile walk alone).
#ifndef BFM_CHAIN_PROBE
#define BFM_CHAIN_PROBE 0
#endif

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
// The packed block, [word][lane] 32-bit words: each lane's B fragments
// (bf16 pairs, lower index in the low half), then its biases (f32) for
// columns 2t and 2t + 1 of each n8 tile.
constexpr int kW0 = 0, kW1 = 4, kW2 = 6, kWu = 7, kWd = 19, kWords = 31;
constexpr int kB0 = 0, kB1 = 4, kB2 = 6, kBu = 8, kBd = 20, kBiases = 24;

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  return pack_bf16x2(fmaxf(lo, 0.0f), fmaxf(hi, 0.0f));
}

__device__ __forceinline__ float silu(float u) {
#if BFM_CHAIN_PROBE == 1
  return u;
#elif BFM_CHAIN_SILU_APPROX
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return u * r;
#else
  return u / (1.0f + expf(-u));
#endif
}

__device__ __forceinline__ uint32_t silu_pack(float lo, float hi) {
  return pack_bf16x2(silu(lo), silu(hi));
}

// Rows g and g + 8 of a tile: channels 4t..4t+3 of subpixel blocks 4 * tile
// + g and + g + 8 (pixels tile * 4 + g / 4 and + 2); zero past the last
// pixel.
__device__ __forceinline__ void load_rows(const uint2* __restrict__ vol,
                                          int64_t n_pix, int64_t tile, int g,
                                          int t, uint2& r0, uint2& r1) {
  const int64_t p0 = tile * 4;
  const int64_t i = (p0 * 4 + g) * 4 + t;
  r0 = p0 + (g >> 2) < n_pix ? __ldcs(vol + i) : make_uint2(0u, 0u);
  r1 = p0 + 2 + (g >> 2) < n_pix ? __ldcs(vol + i + 32) : make_uint2(0u, 0u);
}

// OUT_C = 64: 48 channels then 16 zeros per pixel (B4); 48: NHWC (B7)
template <int OUT_C>
__global__ void __launch_bounds__(kThreads, 2)
    bfm_chain_kernel(const uint2* __restrict__ vol,
                     const uint32_t* __restrict__ pack,
                     uint4* __restrict__ out, int64_t n_pix) {
  constexpr int kPixWords = OUT_C / 2;         // 32-bit words a pixel
  constexpr int kTileWords = 4 * kPixWords;
  constexpr int kChunks = kTileWords / 4;      // 16-byte stores a tile
  __shared__ __align__(16) uint32_t s_out[kWarps][kTileWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool lo = t < 2;
  uint32_t* so = s_out[warp];
  for (int j = lane; j < kTileWords; j += 32) so[j] = 0u;  // B4's pad stays

  uint32_t w[kWords];
  float b[kBiases];
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = pack[j * 32 + lane];
#pragma unroll
  for (int j = 0; j < kBiases; ++j)
    b[j] = __uint_as_float(pack[(kWords + j) * 32 + lane]);
  // word j of tile row r in shared memory: (r / 4) * kPixWords + (r % 4) * 6
  const int row_g = (g >> 2) * kPixWords + (g & 3) * 6;
  const int row_g8 = row_g + 2 * kPixWords;

  const int64_t n_tiles = (n_pix + 3) >> 2;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t tile = (int64_t)blockIdx.x * kWarps + warp;
  uint2 x0, x1;
  load_rows(vol, n_pix, tile, g, t, x0, x1);
  for (; tile < n_tiles; tile += stride) {
    uint2 n0, n1;
    load_rows(vol, n_pix, tile + stride, g, t, n0, n1);
#if BFM_CHAIN_PROBE == 2
    const uint32_t r0 = x0.x, r1 = x1.x, r2 = x0.y, r3 = x1.y;
#else
    // y0: x (k permuted by the pack) times W0, two n8 tiles
    const uint32_t xa[4] = {x0.x, x1.x, x0.y, x1.y};
    float c0[4] = {}, c1[4] = {};
    mma_k16(c0, xa, w[kW0], w[kW0 + 1]);
    mma_k16(c1, xa, w[kW0 + 2], w[kW0 + 3]);
    const uint32_t y0[4] = {relu_pack(c0[0] + b[kB0], c0[1] + b[kB0 + 1]),
                            relu_pack(c0[2] + b[kB0], c0[3] + b[kB0 + 1]),
                            relu_pack(c1[0] + b[kB0 + 2], c1[1] + b[kB0 + 3]),
                            relu_pack(c1[2] + b[kB0 + 2], c1[3] + b[kB0 + 3])};
    // y1, its columns rotated by 4: y1[0:4] in columns 4-7
    float c2[4] = {};
    mma_k16(c2, y0, w[kW1], w[kW1 + 1]);
    const uint32_t y1[2] = {relu_pack(c2[0] + b[kB1], c2[1] + b[kB1 + 1]),
                            relu_pack(c2[2] + b[kB1], c2[3] + b[kB1 + 1])};
    // y2 in columns 0-3 (columns 4-7 have zero weights and biases)
    float c3[4] = {};
    mma_k8(c3, y1[0], y1[1], w[kW2]);
    const uint32_t y2[2] = {relu_pack(c3[0] + b[kB2], c3[1] + b[kB2 + 1]),
                            relu_pack(c3[2] + b[kB2], c3[3] + b[kB2 + 1])};
    // h's A fragment, columns 2t, 2t+1 and 8+2t, 9+2t of rows g and g + 8:
    // y0[0:4] | y1[0:4] | y2[0:4] | 0
    const uint32_t h[4] = {lo ? y0[0] : y1[0], lo ? y0[1] : y1[1],
                           lo ? y2[0] : 0u, lo ? y2[1] : 0u};
    // trans_up -> silu -> trans_down, 16 hidden channels at a time
    float d0[4] = {}, d1[4] = {};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float u0[4] = {}, u1[4] = {};
      mma_k16(u0, h, w[kWu + 4 * k], w[kWu + 4 * k + 1]);
      mma_k16(u1, h, w[kWu + 4 * k + 2], w[kWu + 4 * k + 3]);
      const float* bu = b + kBu + 4 * k;
      const uint32_t a[4] = {silu_pack(u0[0] + bu[0], u0[1] + bu[1]),
                             silu_pack(u0[2] + bu[0], u0[3] + bu[1]),
                             silu_pack(u1[0] + bu[2], u1[1] + bu[3]),
                             silu_pack(u1[2] + bu[2], u1[3] + bu[3])};
      mma_k16(d0, a, w[kWd + 4 * k], w[kWd + 4 * k + 1]);
      mma_k16(d1, a, w[kWd + 4 * k + 2], w[kWd + 4 * k + 3]);
    }
    // out = h + (d + bd), in h's columns
    const float* bd = b + kBd;
    const uint32_t r0 = pack_bf16x2(bf16_lo(h[0]) + (d0[0] + bd[0]),
                                    bf16_hi(h[0]) + (d0[1] + bd[1]));
    const uint32_t r1 = pack_bf16x2(bf16_lo(h[1]) + (d0[2] + bd[0]),
                                    bf16_hi(h[1]) + (d0[3] + bd[1]));
    const uint32_t r2 = pack_bf16x2(bf16_lo(h[2]) + (d1[0] + bd[2]),
                                    bf16_hi(h[2]) + (d1[1] + bd[3]));
    const uint32_t r3 = pack_bf16x2(bf16_lo(h[3]) + (d1[2] + bd[2]),
                                    bf16_hi(h[3]) + (d1[3] + bd[3]));
#endif
    so[row_g + t] = r0;
    so[row_g8 + t] = r1;
    if (lo) {
      so[row_g + 4 + t] = r2;
      so[row_g8 + 4 + t] = r3;
    }
    __syncwarp();
    const int64_t p0 = tile * 4;
    if (lane < kChunks && p0 + lane / (kChunks / 4) < n_pix)
      __stcs(out + p0 * (kChunks / 4) + lane,
             reinterpret_cast<const uint4*>(so)[lane]);
    __syncwarp();
    x0 = n0;
    x1 = n1;
  }
}

template <int OUT_C>
int launch(const void* vol, const void* weights, void* out, int B, int H2,
           int W2, void* stream) {
  const int64_t n_pix = (int64_t)B * H2 * W2;
  if (n_pix <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bfm_chain_kernel<OUT_C>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t need = ((n_pix + 3) / 4 + kWarps - 1) / kWarps;
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  bfm_chain_kernel<OUT_C><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint2*)vol, (const uint32_t*)weights, (uint4*)out, n_pix);
  return (int)cudaGetLastError();
}

}  // namespace

// vol (B, H2, W2*64) bf16, 16-byte aligned; weights the (55, 32) int32
// block of models/stem_chain.py::_pack on the device; out (B, H2, W2*64)
// bf16, 16-byte aligned. Launches on `stream`, no sync.
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
