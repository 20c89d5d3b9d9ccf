// Kernel B2: fused TAF queue update + leaky transform on the folded state.
//
// Replaces frlw_evd_tpu/encode/pallas_update.py::_update_kernel (reached
// through taf_update_leaky). The TPU pipeline first broadcast the per-cell
// mean into a (B, H, W*2K) bf16 plane with jnp.tile and then ran one
// full-lane pass; here each thread owns one pixel, reads its two cells'
// count and t-sum straight from kernel B1's planes and forms the mean in
// registers, so the tiled plane (about 299 MB per GEN1 window batch) never
// exists.
//
// Per pixel of stream b, with C = 2K queue positions (c = 2 * age + p):
//   tm[p] = bf16(tsum[p] / (cnt[p] + 1e-8))   (bf16 rounding as the TPU
//           state stores it; state parity depends on it)
//   if stream b had no event (any_ev[b] == 0): upd = state    (the freeze)
//   else if cnt[c % 2] > 0: upd[c] = c < 2 ? tm[c] : state[c - 2] - 1
//   else:                   upd[c] = state[c] - 1
//   vol[c] = bf16(max(0, 1 - log1p(-upd[c]) / 8.7))
// The state is updated IN PLACE (the TPU call aliases it the same way): a
// thread reads its pixel's C values before it writes them back.
//
// Bound: bytes. At GEN1 B = 128: 597.7 MB state read + 597.7 MB written +
// 298.8 MB of volume + 149.4 MB of count/t-sum planes = 1.64 GB. Each
// thread moves its pixel with 16-byte vector loads and stores. No fast-math:
// log1pf and the division are the IEEE-accurate library forms.

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
__global__ void taf_update_leaky_kernel(float* __restrict__ state,
                                        const float2* __restrict__ cnt,
                                        const float2* __restrict__ tsum,
                                        const int32_t* __restrict__ any_ev,
                                        uint4* __restrict__ vol,
                                        int64_t n_pix, int64_t pix_per_stream) {
  static_assert(C % 8 == 0, "C must be a multiple of 8 for 16-byte stores");
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;

  float4* sp = reinterpret_cast<float4*>(state) + pix * (C / 4);
  float s[C];
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 v = sp[q];
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }

  float u[C];
  if (any_ev[pix / pix_per_stream] != 0) {
    const float2 c = cnt[pix];
    const float2 ts = tsum[pix];
    const bool has[2] = {c.x > 0.0f, c.y > 0.0f};
    const float tm[2] = {bf16_round(ts.x / (c.x + 1e-8f)),
                         bf16_round(ts.y / (c.y + 1e-8f))};
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int p = j & 1;
      u[j] = !has[p] ? s[j] - 1.0f : (j < 2 ? tm[p] : s[j - 2] - 1.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) u[j] = s[j];
  }

#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    sp[q] = make_float4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);

  uint4* vp = vol + pix * (C / 8);
#pragma unroll
  for (int q = 0; q < C / 8; ++q) {
    const float* w = u + 8 * q;
    vp[q] = make_uint4(pack_bf16x2(leaky(w[0]), leaky(w[1])),
                       pack_bf16x2(leaky(w[2]), leaky(w[3])),
                       pack_bf16x2(leaky(w[4]), leaky(w[5])),
                       pack_bf16x2(leaky(w[6]), leaky(w[7])));
  }
}

template <int C>
void launch(void* state, const void* cnt, const void* tsum, const void* any_ev,
            void* vol, int64_t n_pix, int64_t pix_per_stream,
            cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_pix + threads - 1) / threads);
  taf_update_leaky_kernel<C><<<blocks, threads, 0, stream>>>(
      (float*)state, (const float2*)cnt, (const float2*)tsum,
      (const int32_t*)any_ev, (uint4*)vol, n_pix, pix_per_stream);
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
