// Batched float32 segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel segment_sum_pallas
// (thrill_tpu/core/pallas_kernels.py:187, kernel _segsum_kernel :155).
// out[r, s] = sum of val[r, i] over the i with seg[r, i] == s, for s in
// [0, segs); ids outside that range are dropped.
//
// Bound on this card: device memory. The kernel reads 8 bytes per row (an
// int32 id and an f32 value) and writes segs * 4 bytes per row of the
// batch. The TPU kernel carried a VMEM accumulator across an in-order grid
// and summed f32 one-hots, O(segs * n) compares, hence its gate of 4096
// segments. Here blocks run in parallel, so partial sums meet through
// atomics, and any segment count up to the int32 range is taken:
//   * segs <= kSharedSegs (48 KB of f32): each block sums into shared
//     memory, then adds every non-zero bin to the output with one global
//     atomic, so the output sees (blocks per row) atomics per bin;
//   * larger segs (PageRank: 2^22 pages): persistent blocks walk tiles of
//     kTileIds ids. A block merges a tile in an open-addressing table in
//     shared memory (kSlots int32 keys claimed by atomicCAS, f32 sums
//     added by shared atomics), then adds each occupied slot to the output
//     with one global atomic and clears it for the next tile. The table
//     has twice the slots of a tile's ids, so an id always finds a slot;
//     of 4096 and 8192 slots, 8192 was the faster (kernel_times.py,
//     PERF.md). Slots come from a multiplicative hash: Zipf ids are dense
//     near 0, and probing from the id itself piles them into long runs.
//     This merges whatever repeats within a tile, hot ids or not: on the
//     PageRank step's Zipf ids, pages 0-31 share one 128-byte line and
//     carry about a quarter of the ids, and their serial global atomics
//     were the time of the direct-atomic kernel (2.03 ms at [1, 2^24] ids
//     over 2^22 pages, H100 SXM, chip_smoke.py, PERF.md).
// Either way a warp first sums the lanes that carry the same id
// (__match_any_sync, then a shuffle tree over the peer lanes), and only
// the lowest lane of each group adds, so that a warp's repeats of one id
// do not serialise on one atomic.
//
// The sum order differs from a sequential scatter and changes from run to
// run (atomics); the unordered-reduce contract allows it.
//
// The caller zeroes `out`, allocates everything, and passes its stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedSegs = 12288;
constexpr int kLogSlots = 13;
constexpr int kSlots = 1 << kLogSlots;     // 64 KB of int32 keys, f32 sums
constexpr int kTileIds = kSlots / 2;       // ids merged per table fill
constexpr int kTableBlocksPerSm = 3;       // 3 x 64 KB of the SM's 228 KB
constexpr int kEmpty = -1;

// Sum of x over the lanes in `peers` (the lanes whose id equals this
// lane's), left in the lowest lane of the group. Each round, every
// remaining lane adds the value of its next higher remaining peer, then
// the lanes at odd rank among the remaining ones drop out: at most five
// rounds for 32 lanes. All lanes of the warp call this together.
__device__ __forceinline__ float reduce_peers(unsigned peers, float x,
                                              int lane) {
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // peers above this lane
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);  // 1 + lane of the next peer, or 0
    const float t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    peers &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return x;
}

// One id and value per lane, the whole warp together: the lowest lane of
// each group of equal valid ids gets the group's id and sum; the other
// lanes get -1.
__device__ __forceinline__ int merge_peers(int k, float* x, int segs,
                                           int lane) {
  const int key = (k >= 0 && k < segs) ? k : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  *x = reduce_peers(peers, key >= 0 ? *x : 0.0f, lane);
  return (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u) ? key : -1;
}

__device__ __forceinline__ void add(float* acc, int k, float x, int segs,
                                    int lane) {
  const int key = merge_peers(k, &x, segs, lane);
  if (key >= 0) atomicAdd(&acc[key], x);
}

// Add x to key's slot of the open-addressing table (linear probing from a
// multiplicative hash, so neighbouring ids land far apart); a slot is
// claimed with atomicCAS. The table never fills: it has twice the slots
// of a tile's ids.
__device__ __forceinline__ void table_add(int* keys, float* sums, int key,
                                          float x) {
  unsigned h = (static_cast<unsigned>(key) * 2654435761u) >>
               (32 - kLogSlots);
  while (true) {
    int k = *reinterpret_cast<volatile int*>(keys + h);
    if (k == kEmpty) k = atomicCAS(keys + h, kEmpty, key);
    if (k == kEmpty || k == key) {
      atomicAdd(sums + h, x);
      return;
    }
    h = (h + 1) & (kSlots - 1);
  }
}

__device__ __forceinline__ void table_insert(int* keys, float* sums, int k,
                                             float x, int segs, int lane) {
  const int key = merge_peers(k, &x, segs, lane);
  if (key >= 0) table_add(keys, sums, key, x);
}

// segs <= kSharedSegs: sum into shared memory, flush the non-zero bins.
// kVec: the row holds a multiple of 4 ids, so each lane loads 16 bytes of
// ids and 16 of values at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segsum_shared_kernel(const int32_t* __restrict__ seg,
                         const float* __restrict__ val,
                         float* __restrict__ out, long long n, int segs) {
  extern __shared__ float sh[];
  const int row = blockIdx.y;
  const int32_t* s = seg + static_cast<long long>(row) * n;
  const float* v = val + static_cast<long long>(row) * n;
  float* o = out + static_cast<long long>(row) * segs;
  for (int b = threadIdx.x; b < segs; b += blockDim.x) sh[b] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long units = kVec ? n / 4 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // `base` is warp-uniform, so every lane takes part in the warp
  // primitives even on the ragged tail (out-of-range lanes carry id -1)
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < units; base += stride) {
    const long long i = base + lane;
    if (kVec) {
      int4 k = make_int4(-1, -1, -1, -1);
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < units) {
        k = __ldg(reinterpret_cast<const int4*>(s) + i);
        x = __ldg(reinterpret_cast<const float4*>(v) + i);
      }
      add(sh, k.x, x.x, segs, lane);
      add(sh, k.y, x.y, segs, lane);
      add(sh, k.z, x.z, segs, lane);
      add(sh, k.w, x.w, segs, lane);
    } else {
      int k = -1;
      float x = 0.0f;
      if (i < units) {
        k = __ldg(s + i);
        x = __ldg(v + i);
      }
      add(sh, k, x, segs, lane);
    }
  }

  __syncthreads();
  // adding +0.0 to the zeroed output changes no bit, so zero bins skip
  for (int b = threadIdx.x; b < segs; b += blockDim.x) {
    const float c = sh[b];
    if (c != 0.0f) atomicAdd(&o[b], c);
  }
}

// segs > kSharedSegs: persistent blocks merge tiles of kTileIds ids in the
// shared table and flush one global atomic per occupied slot.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    segsum_table_kernel(const int32_t* __restrict__ seg,
                        const float* __restrict__ val,
                        float* __restrict__ out, long long n, int segs) {
  extern __shared__ int tbl[];
  int* keys = tbl;                                       // [kSlots]
  float* sums = reinterpret_cast<float*>(tbl + kSlots);  // [kSlots]
  for (int j = threadIdx.x; j < kSlots; j += kThreads) {
    keys[j] = kEmpty;
    sums[j] = 0.0f;
  }
  __syncthreads();
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int32_t* s = seg + static_cast<long long>(row) * n;
  const float* v = val + static_cast<long long>(row) * n;
  float* o = out + static_cast<long long>(row) * segs;
  const long long tiles = (n + kTileIds - 1) / kTileIds;
  constexpr int kPer = kTileIds / (kVec ? 4 : 1) / kThreads;  // loads a lane
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    // every lane runs the same trip count: the tail carries id -1
    const long long u0 = t * (kTileIds / (kVec ? 4 : 1)) + threadIdx.x;
    const long long units = kVec ? n / 4 : n;
    if (kVec) {
      int4 k[kPer];
      float4 x[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long i = u0 + j * kThreads;
        k[j] = make_int4(-1, -1, -1, -1);
        x[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < units) {
          k[j] = __ldg(reinterpret_cast<const int4*>(s) + i);
          x[j] = __ldg(reinterpret_cast<const float4*>(v) + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        table_insert(keys, sums, k[j].x, x[j].x, segs, lane);
        table_insert(keys, sums, k[j].y, x[j].y, segs, lane);
        table_insert(keys, sums, k[j].z, x[j].z, segs, lane);
        table_insert(keys, sums, k[j].w, x[j].w, segs, lane);
      }
    } else {
      for (int j = 0; j < kPer; ++j) {
        const long long i = u0 + j * kThreads;
        int k = -1;
        float x = 0.0f;
        if (i < units) {
          k = __ldg(s + i);
          x = __ldg(v + i);
        }
        table_insert(keys, sums, k, x, segs, lane);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < kSlots; j += kThreads) {
      const int k = keys[j];
      if (k != kEmpty) {
        atomicAdd(&o[k], sums[j]);
        keys[j] = kEmpty;
        sums[j] = 0.0f;
      }
    }
    __syncthreads();
  }
}

long long clamp_blocks(long long want, long long cap) {
  if (cap < 1) cap = 1;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

template <bool kVec>
cudaError_t launch(const int32_t* seg, const float* val, float* out,
                   long long n, int rows, int segs, int sms,
                   cudaStream_t stream) {
  if (segs <= kSharedSegs) {
    // each block sums at least 8 * segs ids, so its flush of segs bins
    // stays a small share of the work
    const long long units = kVec ? n / 4 : n;
    long long want = (units + kThreads - 1) / kThreads;
    const long long per = (n + 8LL * segs - 1) / (8LL * segs);
    if (per < want) want = per;
    const dim3 grid(static_cast<unsigned>(
                        clamp_blocks(want, (8LL * sms) / rows)), rows);
    segsum_shared_kernel<kVec><<<grid, kThreads, segs * sizeof(float),
                                 stream>>>(seg, val, out, n, segs);
    return cudaGetLastError();
  }
  const int smem = 2 * kSlots * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      segsum_table_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (n + kTileIds - 1) / kTileIds;
  const dim3 grid(static_cast<unsigned>(clamp_blocks(
                      tiles, (kTableBlocksPerSm * static_cast<long long>(sms))
                                 / rows)), rows);
  segsum_table_kernel<kVec><<<grid, kThreads, smem, stream>>>(seg, val, out,
                                                              n, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int thrill_segment_sum(const int32_t* seg, const float* val,
                                  float* out, long long n, int rows, int segs,
                                  int sms, cudaStream_t stream) {
  if (n <= 0 || rows <= 0 || segs <= 0)
    return static_cast<int>(cudaGetLastError());
  // rows start 16-byte aligned when n % 4 == 0 (torch aligns the bases)
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(val) % 16 == 0)
    return static_cast<int>(launch<true>(seg, val, out, n, rows, segs, sms,
                                         stream));
  return static_cast<int>(launch<false>(seg, val, out, n, rows, segs, sms,
                                        stream));
}
