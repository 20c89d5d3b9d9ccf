// Kernels B2, B3 and B5: fused TAF queue update + leaky transform, on the
// folded full-resolution state (B2) and on the patchified quarter-resolution
// state of the 1 Mpx path (B3 and B5). All three launch the one kernel body
// below.
//
// B2 replaces frlw_evd_tpu/encode/pallas_update.py::_update_kernel (reached
// through taf_update_leaky). The TPU pipeline first broadcast the per-cell
// mean into a (B, H, W*2K) bf16 plane with jnp.tile and then ran one
// full-lane pass; here a thread reads its pixel's two cells' count and t-sum
// straight from kernel B1's planes and forms the mean in registers, so the
// tiled plane (about 299 MB per GEN1 window batch) never exists.
//
// B3 replaces ::_update_kernel_raw (reached through taf_update_leaky_raw).
// Its state is the patchified queue (B, H/2, (W/2)*64): per
// quarter-resolution pixel, 4 subpixel blocks (s = (x&1)*2 + (y&1)) of 16
// queue positions, and its counts and t-sums come from kernel B1 in the p64
// order, cell pix*8 + s*2 + p. Read as the folded queue of a (H/2, (W/2)*4)
// grid with 2K = 16, each subpixel block is one B2 pixel and its two cells
// are that pixel's cells, so B3 is B2 at that geometry (the JAX package does
// the same, pallas_update.py:388-389). The TPU kernel read the scatter's raw
// (R, 256) lanes and broadcast each cell to its 8 channels with a 0/1
// expansion matmul because it has no gather; a thread here reads its cells.
//
// B5 replaces ::_update_kernel_v2 (reached through taf_update_leaky_v2), the
// update of the p64 step's precise and sorted paths. The TPU kernel reads
// the histogram as (B, H/2, (W/2)*8) count and t-sum planes in (pixel,
// subpixel, polarity) order and broadcasts each cell to its channels with
// the same 0/1 expansion matmul. Those planes hold the same bytes in the
// same order as B1's p64-order planes, so B5 is B3 over other producers'
// planes: its own C entry, the same launch.
//
// Per pixel of stream b, with C = 2K queue positions (c = 2 * age + p):
//   tm[p] = bf16(tsum[p] / (cnt[p] + 1e-8))   (bf16 rounding as the TPU
//           state stores it; state parity depends on it)
//   if stream b had no event (any_ev[b] == 0): upd = state    (the freeze)
//   else if cnt[c % 2] > 0: upd[c] = c < 2 ? tm[c] : state[c - 2] - 1
//   else:                   upd[c] = state[c] - 1
//   vol[c] = bf16(max(0, 1 - log1p(-upd[c]) / 8.7))
//
// Bound: bytes. At GEN1 B = 128: 597.7 MB state read + 597.7 MB written +
// 298.8 MB of volume + 149.4 MB of count/t-sum planes = 1.64 GB; at gen4
// B = 128, 512x640 (B3 and B5 alike): 2.684 GB of state read and
// written, 1.342 GB of volume, 0.671 GB of count/t-sum planes. One thread
// per float4 of state (4 queue positions), so a warp moves 512 contiguous
// bytes of state with each load and store and 256 of volume (8 B a
// thread); a thread per pixel ran 10-13%
// slower at both shapes (PERF.md). The two older positions c0-2, c0-1 that
// a quad shifts in come from the neighbouring lane by warp shuffle, read
// before any lane writes, so the in-place update (the TPU call aliases the
// state the same way) is safe; a quad with c0 = 0 takes the new mean and
// needs no neighbour, and lane 0 of every warp is one, since the C/4 quads
// of a pixel divide 32. No fast-math: log1pf and the division are the
// IEEE-accurate library forms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvLeaky = 0.11494252873563218f;  // 1 / 8.7, as f32

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float leaky(float u) {
  const float lk = 1.0f - log1pf(-u) * kInvLeaky;
  return lk < 0.0f ? 0.0f : lk;  // NaN passes through, as jnp.maximum
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int C>
__global__ void taf_update_leaky_kernel(float4* __restrict__ state,
                                        const float2* __restrict__ cnt,
                                        const float2* __restrict__ tsum,
                                        const int32_t* __restrict__ any_ev,
                                        uint2* __restrict__ vol,
                                        int64_t n_quads,
                                        int64_t quads_per_stream) {
  constexpr int Q = C / 4;  // quads per pixel
  static_assert(C == 8 || C == 16, "a pixel's quads must divide a warp");
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_quads;
  const float4 v = active ? state[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  // every lane takes part in the shuffles, inactive tail lanes included
  const float prev_z = __shfl_up_sync(0xffffffffu, v.z, 1);
  const float prev_w = __shfl_up_sync(0xffffffffu, v.w, 1);
  if (!active) return;

  const int c0 = (int)(i % Q) * 4;  // first queue position of the quad
  const float s[4] = {v.x, v.y, v.z, v.w};
  float u[4];
  if (any_ev[i / quads_per_stream] != 0) {
    const float2 c = cnt[i / Q];  // the pixel's two cells
    const float2 ts = tsum[i / Q];
    const bool has[2] = {c.x > 0.0f, c.y > 0.0f};
    const float tm[2] = {bf16_round(ts.x / (c.x + 1e-8f)),
                         bf16_round(ts.y / (c.y + 1e-8f))};
    const float older[4] = {prev_z, prev_w, v.x, v.y};  // state[c - 2]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = j & 1;
      u[j] = !has[p] ? s[j] - 1.0f : (c0 + j < 2 ? tm[p] : older[j] - 1.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = s[j];
  }
  state[i] = make_float4(u[0], u[1], u[2], u[3]);
  vol[i] = make_uint2(pack_bf16x2(leaky(u[0]), leaky(u[1])),
                      pack_bf16x2(leaky(u[2]), leaky(u[3])));
}

template <int C>
void launch(void* state, const void* cnt, const void* tsum, const void* any_ev,
            void* vol, int64_t n_pix, int64_t pix_per_stream,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t n_quads = n_pix * (C / 4);
  const unsigned blocks = (unsigned)((n_quads + threads - 1) / threads);
  taf_update_leaky_kernel<C><<<blocks, threads, 0, stream>>>(
      (float4*)state, (const float2*)cnt, (const float2*)tsum,
      (const int32_t*)any_ev, (uint2*)vol, n_quads, pix_per_stream * (C / 4));
}

}  // namespace

// state (B, H, W*C) f32, updated in place; cnt, tsum (B, H*W*2) f32;
// any_ev (B,) i32; vol (B, H, W*C) bf16 out. C = 2K is 8 or 16; any other
// value returns cudaErrorInvalidValue without launching.
extern "C" int taf_update_leaky(void* state, const void* cnt, const void* tsum,
                                const void* any_ev, void* vol, int B, int H,
                                int W, int C, void* stream) {
  const int64_t pix_per_stream = (int64_t)H * W;
  const int64_t n_pix = (int64_t)B * pix_per_stream;
  if (n_pix > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (C == 16) {
      launch<16>(state, cnt, tsum, any_ev, vol, n_pix, pix_per_stream, s);
    } else if (C == 8) {
      launch<8>(state, cnt, tsum, any_ev, vol, n_pix, pix_per_stream, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// state (B, H/2, (W/2)*64) f32 p64 queue, updated in place; cnt, tsum
// (B, H*W*2) f32 in B1's p64 order; any_ev (B,) i32; vol (B, H/2, (W/2)*64)
// bf16 out. H2 = H/2, W2 = W/2 quarter-resolution pixels per stream; each
// has 4 subpixel blocks of 2K = 16, the pixels of B2's body.
extern "C" int taf_update_leaky_raw(void* state, const void* cnt,
                                    const void* tsum, const void* any_ev,
                                    void* vol, int B, int H2, int W2,
                                    void* stream) {
  const int64_t blocks_per_stream = (int64_t)H2 * W2 * 4;
  const int64_t n_blocks = (int64_t)B * blocks_per_stream;
  if (n_blocks > 0)
    launch<16>(state, cnt, tsum, any_ev, vol, n_blocks, blocks_per_stream,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// state (B, H2, W2*64) f32 p64 queue, updated in place; cnt_r, tsum_r
// (B, H2, W2*8) f32 in (pixel, subpixel, polarity) order; any_ev (B,) i32;
// vol (B, H2, W2*64) bf16 out. The same launch as taf_update_leaky_raw: a
// quarter-resolution pixel's 8 cells are its 4 subpixel blocks' 2 cells.
extern "C" int taf_update_leaky_v2(void* state, const void* cnt_r,
                                   const void* tsum_r, const void* any_ev,
                                   void* vol, int B, int H2, int W2,
                                   void* stream) {
  const int64_t blocks_per_stream = (int64_t)H2 * W2 * 4;
  const int64_t n_blocks = (int64_t)B * blocks_per_stream;
  if (n_blocks > 0)
    launch<16>(state, cnt_r, tsum_r, any_ev, vol, n_blocks, blocks_per_stream,
               (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
