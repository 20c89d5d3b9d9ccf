// Kernel B1: per-stream event histogram (count and t-sum) for the TAF encode.
//
// Replaces frlw_evd_tpu/encode/pallas_scatter.py::_packed_kernel (reached
// through scatter_cnt_tsum_pallas_sorted(precise=False)). The TPU version
// sorts packed (cell, quantised t) keys and accumulates banded one-hot
// matmuls in VMEM because the TPU has no fast scatter; its bands, SMEM flags
// and serial fallback exist only for that. Here the histogram is an
// output-stationary cluster tile (hist_tile.cuh): each cluster of 8 blocks
// holds a range of one stream's cells in shared memory, reads the stream's
// events once with 16-byte loads, adds [1, t - 1] for each counted event
// into the owning block's tile (lanes that hit one cell summed in registers
// first, so hot cells of clustered streams do not serialise), and writes
// both planes once. There is no zero fill and there are no global atomics,
// and no sort, so clustered streams are exact too; t is kept exact (the TPU
// path quantises it to 12 bits and rounds it to bf16).
//
// Accumulator: the cell's count and its t-sum as integers in one u64
// (hist_tile.cuh), t - 1 at a least significant bit of 2^-24. Every t - 1
// of an f32 t in [0, 1] is such a multiple, so the t-sums are exact and the
// same from launch to launch; an f32 accumulator would cost a
// compare-and-swap loop per add (shared memory has no native f32 add on
// sm_90) and only 8 bytes a cell all the same. E < 2^17; a counted event
// with |t - 1| >= 2^(21 - ceil(log2 E)) (32 at E = 65536) makes its cell's
// t-sum NaN.
//
// Semantics (frlw_evd_tpu/encode/pallas_update.py:111-119): x, y, p are
// truncated toward zero (as astype(int32) does), so x = -0.5 is cell 0; an
// event counts when e < n_valid[b] and 0 <= x < W, 0 <= y < H, 0 <= p < 2;
// its cell index is (y * W + x) * 2 + p in the folded order (layout 0), or
// (((y >> 1) * (W / 2) + (x >> 1)) * 4 + s) * 2 + p with subpixel
// s = (x & 1) * 2 + (y & 1) in the patchified p64 order of the
// quarter-resolution queue (layout 1, pallas_update.py:338-340). any_ev[b]
// is 1 when stream b had at least one counted event, else 0 (the
// whole-frame freeze flag of kernels B2 and B3), written once by the
// stream's first cluster, which scans every event.
//
// Bound: bytes. At GEN1 B = 128, E = 16384 it reads 33.6 MB of events and
// writes 149.4 MB of planes (0.055 ms at 3.35 TB/s): one cluster a stream
// (18240 cells, 146 KB a block), each event read once. At gen4 B = 128,
// E = 65536, 512x640, 134.2 MB of events and 671.1 MB of planes (0.240 ms):
// three clusters a stream (27308 cells, 218 KB a block).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_tile.cuh"

namespace {

// Event e of stream b, decoded as above; its addend is t - 1.
struct EventFront {
  const float4* xytp;
  const int32_t* n_valid;
  int E, H, W, layout;

  __device__ __forceinline__ hist_tile::Slot load(int b, int e, int lo,
                                                  int span, bool* seen) const {
    hist_tile::Slot s = {-1, 0.0f};
    if (e >= E || e >= __ldg(n_valid + b)) return s;
    const float4 ev = __ldg(xytp + (int64_t)b * E + e);
    const int x = __float2int_rz(ev.x);
    const int y = __float2int_rz(ev.y);
    const int p = __float2int_rz(ev.w);
    if (x < 0 || x >= W || y < 0 || y >= H || p < 0 || p > 1) return s;
    const int cell = layout == 0
        ? (y * W + x) * 2 + p
        : (((y >> 1) * (W >> 1) + (x >> 1)) * 4 + (x & 1) * 2 + (y & 1)) * 2 +
              p;
    *seen = true;
    if (cell >= lo && cell - lo < span) s.local = cell - lo;
    s.t = ev.z - 1.0f;
    return s;
  }
};

}  // namespace

// xytp (B, E, 4) f32 16-byte aligned, n_valid (B,) i32; cnt, tsum
// (B, H*W*2) f32 and any_ev (B,) i32, every element written; layout 0
// (folded) or 1 (p64, H and W even). Tiling: `clusters` clusters of `cs`
// blocks per stream, `cells` cells a block (encode/scatter.py::tile_plan).
// An invalid layout or tiling returns cudaErrorInvalidValue without
// launching. Launches on `stream`, no sync.
extern "C" int scatter_cnt_tsum(const void* xytp, const void* n_valid,
                                void* cnt, void* tsum, void* any_ev, int B,
                                int E, int H, int W, int layout, int clusters,
                                int cs, int cells, void* stream) {
  if (layout != 0 && !(layout == 1 && H % 2 == 0 && W % 2 == 0))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)H * W * 2 > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EventFront front{(const float4*)xytp, (const int32_t*)n_valid, E, H,
                         W, layout};
  return hist_tile::launch(front, cnt, tsum, any_ev, B, E, H * W * 2,
                           clusters, cs, cells, (cudaStream_t)stream);
}
