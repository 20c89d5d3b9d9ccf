// Output-stationary histogram tiles in thread-block clusters: the engine of
// kernels B1 (scatter_hist.cu), B6 (scatter_sorted.cu) and B8
// (scatter_dense.cu).
//
// A stream's per-cell histogram is cut into contiguous cell ranges. A
// cluster of `cs` blocks owns one range and each of its blocks owns a slice
// of `cells` cells of it in dynamic shared memory (grid: clusters * cs
// blocks along x per stream, the streams along y, so the clusters of one
// stream are launched together and re-read its slots out of L2). The
// cluster's threads stream the stream's slots once, each block a strided
// share, with coalesced loads. A slot that counts in the cluster's range is
// added into the owning block's shared memory through distributed shared
// memory: `red.relaxed.cluster.shared::cluster` reductions, which do not
// wait for a reply. After cluster.sync() each block writes its slice of
// both output planes once, with 16-byte stores where the plane allows: no
// zero fill, no global atomics, every output cell written exactly once.
//
// Hot cells: where neighbouring lanes of a warp hit the same cell, the
// warp's lanes are grouped by cell with __match_any_sync and each group's
// addends summed with a shuffle tree (reduce_peers), so one lane issues one
// add for the whole group. A stream whose events all fall in one cell
// costs one add per warp and pass instead of 32.
//
// The tiling (clusters per stream, cells per block, cluster size) is chosen
// by the caller (encode/scatter.py::tile_plan); `launch` checks it.
//
// A front end `Front` turns (stream, slot) into a Slot, and notes whether
// the slot counts anywhere in its stream. A cell policy `Cell` says what a
// cell of 8 bytes holds, how a group of peers adds into it and how it is
// written out:
// - Packed (B1, B6): the count and the t-sum as integers in one u64, so one
//   64-bit reduction adds a whole group: integer adds commute (every launch
//   gives the same bits) and are native in the shared-memory atomic unit,
//   where an f32 add there is a compare-and-swap loop (nvcc emits
//   ATOMS.CAST.SPIN for a local f32 atomicAdd on sm_90 and ATOM.E.CAST.SPIN
//   for one into another block's tile). t is bounded (below).
// - Dense (B8): a u32 count and an f32 t-sum, for any f32 t. The peers' t
//   are summed in registers first, and one 64-bit compare-and-swap per
//   cell per warp pass updates count and t-sum together.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hist_tile {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;              // slots in flight per thread
constexpr int kMaxSmem = 232448;        // 227 KB a block on sm_90
constexpr int kFlagBytes = 16;          // the any-event flag after the cells
constexpr unsigned kFull = 0xffffffffu;

// A slot as the engine sees it: its cell relative to the cluster's first
// cell (negative when it adds nothing here) and its t.
struct Slot {
  int local;
  float t;
};

// The shared::cluster address of `local` (in this block's shared memory)
// in the tile of block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 unsigned rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(out)
      : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}

// Reductions into a cluster block's shared memory, relaxed at cluster
// scope: the cluster barrier orders them before the tile is read.
__device__ __forceinline__ void red_add(uint32_t addr, unsigned long long v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u64 [%0], %1;"
               :: "r"(addr), "l"(v) : "memory");
}
__device__ __forceinline__ void red_or(uint32_t addr, unsigned long long v) {
  asm volatile("red.relaxed.cluster.shared::cluster.or.b64 [%0], %1;"
               :: "r"(addr), "l"(v) : "memory");
}
__device__ __forceinline__ void red_or(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.or.b32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}
// Compare-and-swap of a cluster block's 64-bit shared word; returns what
// the word held.
__device__ __forceinline__ unsigned long long cas(uint32_t addr,
                                                  unsigned long long cmp,
                                                  unsigned long long val) {
  unsigned long long old;
  asm volatile("atom.relaxed.cluster.shared::cluster.cas.b64 %0, [%1], %2, %3;"
               : "=l"(old) : "r"(addr), "l"(cmp), "l"(val) : "memory");
  return old;
}

// Sum v over each group of peers (lanes sharing a key); the lowest lane of
// a group ends with the group's sum. Every lane of the warp takes part.
// (E. Westphal's peer reduction: log2(group size) shuffle rounds.)
template <class V>
__device__ __forceinline__ V reduce_peers(unsigned peers, int lane, V v) {
  unsigned rel = __popc(peers & ((1u << lane) - 1u));  // my rank in the group
  unsigned above = peers & ~((2u << lane) - 1u);       // peers above me
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1-based lane of my next live peer
    const V other = __shfl_sync(kFull, v, next ? next - 1 : lane);
    if (next) v += other;
    above &= ~__ballot_sync(kFull, rel & 1u);  // odd ranks are absorbed
    rel >>= 1;
  }
  return v;
}

// The shared::cluster address of cell `local` of the cluster's range: in
// the tile of the block that owns it, `cells` cells of 8 bytes a block.
__device__ __forceinline__ uint32_t cell_addr(const char* smem, int local,
                                              int cells) {
  const int owner = local / cells;
  return cluster_addr(smem, owner) + (uint32_t)(local - owner * cells) * 8u;
}

// One cell, one u64: bits [0, 46) the t-sum as a signed integer at a least
// significant bit of 2^-24, bits [46, 63) the count, bit 63 a poison flag.
// An addend is 2^46 + round(t * 2^24) (one count and t), so a group of n
// lanes adds n * 2^46 + its t-sum in one reduction. Each t is rounded once
// to the nearest multiple of 2^-24, which every t - 1 of an f32 t in
// [0, 1] already is; the integer sum is exact and order-free; it is
// rounded once to f32. The fields stay apart while count < 2^17 (E < 2^17)
// and |t-sum| < 2^21, which |t| < limit = 2^(21 - ceil(log2 E)) ensures
// (32 at E = 65536). An addend outside that (or NaN) is counted but not
// summed, and sets the poison bit, which writes its cell's t-sum as NaN.
struct Packed {
  using V = unsigned long long;
  static constexpr int kMaxSlots = 1 << 17;  // E < kMaxSlots a launch
  static constexpr int kSumBits = 46;
  static constexpr V kOne = 1ull << kSumBits;  // one count
  static constexpr V kPoison = 1ull << 63;

  static __device__ __forceinline__ V encode(float t, float limit,
                                             bool* bad) {
    *bad = !(fabsf(t) < limit);
    return kOne + (V)(*bad ? 0ll : __float2ll_rn(t * 16777216.0f));
  }
  // A group of peers adds its packed sum through its lowest lane.
  static __device__ __forceinline__ void add(bool hit, const Slot& s,
                                             unsigned peers, int lane,
                                             float limit, const char* smem,
                                             int cells) {
    bool bad = false;
    const V v = reduce_peers(peers, lane,
                             hit ? encode(s.t, limit, &bad) : (V)0);
    if (!hit) return;
    const uint32_t addr = cell_addr(smem, s.local, cells);
    if (bad) red_or(addr, kPoison);
    if (lane == __ffs(peers) - 1) red_add(addr, v);
  }
  static __device__ __forceinline__ void cell(V w, float* cn, float* ts) {
    const bool poisoned = w & kPoison;
    w &= ~kPoison;
    long long s = (long long)(w & (kOne - 1));
    if (s >= (long long)(kOne >> 1)) s -= (long long)kOne;
    *cn = (float)((w - (V)s) >> kSumBits);
    *ts = poisoned ? __int_as_float(0x7fc00000)
                   : __ll2float_rn(s) * (1.0f / 16777216.0f);
  }
};

// One cell, two 32-bit words: the count (u32, low) and the t-sum (f32,
// high), for any f32 t: no range, no poison. sm_90 has no native f32 add
// into shared memory: for red.shared::cluster.add.f32 nvcc emits a
// compare-and-swap loop on either shared window (ATOMS.CAST.SPIN into the
// block's own tile, ATOM.E.CAST.SPIN into another's; ATOM.E.ADD.F32 only
// for a global address), beside the count's own atomic. So a group of n
// peers sums its t in registers (reduce_peers) and its lowest lane updates
// the whole cell with one 64-bit compare-and-swap: (count + n, f32(t-sum +
// t)). It first guesses the cell empty, so a cell's first add, which is
// most adds on a sparse stream, takes one CAS and no load; a failed CAS
// returns the cell, and the next try starts from that. The f32 adds of a
// cell run in an order that changes from launch to launch, so its t-sum
// agrees with any other order of the same adds to f32 rounding.
struct Dense {
  using V = unsigned long long;
  static constexpr int kMaxSlots = 1 << 30;

  static __device__ __forceinline__ void add(bool hit, const Slot& s,
                                             unsigned peers, int lane, float,
                                             const char* smem, int cells) {
    const float t = reduce_peers(peers, lane, hit ? s.t : 0.0f);
    if (!hit || lane != __ffs(peers) - 1) return;
    const uint32_t addr = cell_addr(smem, s.local, cells);
    const unsigned n = __popc(peers);
    V old = 0;
    for (;;) {
      const float sum = __fadd_rn(__uint_as_float((unsigned)(old >> 32)), t);
      const V seen = cas(addr, old,
                         ((V)__float_as_uint(sum) << 32) | ((unsigned)old + n));
      if (seen == old) return;
      old = seen;
    }
  }
  static __device__ __forceinline__ void cell(V w, float* cn, float* ts) {
    *cn = (float)(unsigned)(w & 0xffffffffull);
    *ts = __uint_as_float((unsigned)(w >> 32));
  }
};

constexpr int kCellBytes = 8;
static_assert(sizeof(Packed::V) == kCellBytes && sizeof(Dense::V) ==
              kCellBytes, "a cell is 8 bytes");

// Convert and write n cells of a tile to the planes at cnt and tsum.
template <class Cell>
__device__ void store(const char* smem, int n, float* cnt, float* tsum,
                      bool vec) {
  using V = typename Cell::V;
  const V* w = reinterpret_cast<const V*>(smem);
  if (vec) {  // n is a multiple of 4 and both planes 16-byte aligned here
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) {
      const ulonglong2 w01 = *reinterpret_cast<const ulonglong2*>(w + i);
      const ulonglong2 w23 = *reinterpret_cast<const ulonglong2*>(w + i + 2);
      float4 cn, ts;
      Cell::cell(w01.x, &cn.x, &ts.x);
      Cell::cell(w01.y, &cn.y, &ts.y);
      Cell::cell(w23.x, &cn.z, &ts.z);
      Cell::cell(w23.y, &cn.w, &ts.w);
      *reinterpret_cast<float4*>(cnt + i) = cn;
      *reinterpret_cast<float4*>(tsum + i) = ts;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      Cell::cell(w[i], cnt + i, tsum + i);
  }
}

// One slot of one warp: each hit lane adds into the owning block's tile.
// Where lanes 1 or 2 apart share a cell (as a hot cell's events do), the
// warp groups its lanes by cell first and the group's lowest lane adds the
// whole group. The grouping (__match_any_sync) is skipped otherwise: on
// uniform streams it costs more than the rare collision it saves.
template <class Cell>
__device__ __forceinline__ void add_slot(const Slot& s, const char* smem,
                                         int cells, float limit, int lane) {
  const bool hit = s.local >= 0;
  if (!__any_sync(kFull, hit)) return;
  const int key = hit ? s.local : -1 - lane;  // misses stay alone
  const int key1 = __shfl_xor_sync(kFull, key, 1);
  const int key2 = __shfl_xor_sync(kFull, key, 2);
  const unsigned peers = __any_sync(kFull, key1 == key || key2 == key)
                             ? __match_any_sync(kFull, key)
                             : 1u << lane;
  Cell::add(hit, s, peers, lane, limit, smem, cells);
}

// Slot e of stream b of (idx, t, valid) slots (B6, B8): counted when valid
// and 0 <= idx < size.
struct CellFront {
  const int32_t* idx;
  const float* t;
  const uint8_t* valid;
  int E, size;

  __device__ __forceinline__ Slot load(int b, int e, int lo, int span,
                                       bool*) const {
    Slot s = {-1, 0.0f};
    if (e >= E) return s;
    const int64_t i = (int64_t)b * E + e;
    const int32_t c = __ldg(idx + i);
    if (__ldg(valid + i) && c < size && c >= lo && c - lo < span)
      s.local = c - lo;
    s.t = __ldg(t + i);
    return s;
  }
};

template <class Front, class Cell>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(Front front, float* __restrict__ cnt, float* __restrict__ tsum,
            int32_t* __restrict__ any_out, int E, int size, int cells,
            float limit) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int lo = (int)(blockIdx.x - rank) * cells;  // the cluster's first cell
  const int span = cs * cells;
  const int lane = threadIdx.x & 31;
  const int tile_bytes = cells * kCellBytes + kFlagBytes;
  int* flag = reinterpret_cast<int*>(smem + cells * kCellBytes);

  for (int i = threadIdx.x * 16; i < tile_bytes; i += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  cluster.sync();  // every tile of the cluster is zero before any add

  // the cluster's blocks take turns of kThreads slots; base is warp-uniform
  const int step = cs * kThreads;
  bool seen = false;
  for (int base = rank * kThreads + (int)(threadIdx.x & ~31u); base < E;
       base += kUnroll * step) {
    Slot s[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      s[k] = front.load(b, base + k * step + lane, lo, span, &seen);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      add_slot<Cell>(s[k], smem, cells, limit, lane);
  }

  // any_out[b]: the first cluster of a stream scans every slot of it
  const bool first = blockIdx.x < (unsigned)cs;
  if (any_out != nullptr && first && __syncthreads_or(seen) &&
      threadIdx.x == 0)
    red_or(cluster_addr(flag, 0), 1);
  cluster.sync();  // every add into this block's tile has landed

  const int start = lo + rank * cells;
  const int n = max(0, min(cells, size - start));
  store<Cell>(smem, n, cnt + (int64_t)b * size + start,
              tsum + (int64_t)b * size + start, size % 4 == 0);
  if (any_out != nullptr && first && rank == 0 && threadIdx.x == 0)
    any_out[b] = *flag;
}

// Launch `front` over B streams of E slots into (B, size) count and t-sum
// planes (and any_out (B,) unless null), `clusters` clusters of `cs`
// blocks per stream, `cells` cells a block, each cell a `Cell`. Returns a
// CUDA error code: cudaErrorInvalidValue, without launching, for
// E >= Cell::kMaxSlots, a tiling that does not cover [0, size) or leaves a
// cluster empty, a slice that is not a multiple of 4 cells, or one that
// does not fit a block's shared memory.
template <class Front, class Cell = Packed>
int launch(const Front& front, void* cnt, void* tsum, void* any_out, int B,
           int E, int size, int clusters, int cs, int cells,
           cudaStream_t stream) {
  const int64_t span = (int64_t)clusters * cs * cells;
  const int64_t smem = (int64_t)cells * kCellBytes + kFlagBytes;
  if (B < 0 || B > 65535 || E < 0 || E >= Cell::kMaxSlots || size <= 0 ||
      clusters <= 0 || cs < 1 || cs > 8 || cells <= 0 || cells % 4 ||
      span < size || span - size >= (int64_t)cs * cells ||
      span > 0x7fffffff || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  int bits = 0;  // ceil(log2 E)
  while ((1 << bits) < E) ++bits;
  auto kernel = tile_kernel<Front, Cell>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cs), (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, front, (float*)cnt, (float*)tsum,
                           (int32_t*)any_out, E, size, cells,
                           ldexpf(1.0f, 21 - bits));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace hist_tile
