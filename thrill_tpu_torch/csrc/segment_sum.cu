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
//   * larger segs (PageRank: 2^20 pages per worker): direct global
//     atomics into the zeroed output.
// Either way a warp first sums the lanes that carry the same id
// (__match_any_sync, then a shuffle tree over the peer lanes), and only
// the lowest lane of each group adds. On PageRank's Zipf targets the
// hottest page holds about 6 % of the ids, about 2 lanes of a warp step,
// and its atomics serialise on one address: the peer sum halves them.
// It merges only a few per cent of all atomics, yet took the kernel from
// 3.07 to 2.03 ms on the PageRank step's 2^24 ids over 2^22 pages
// (H100 SXM, chip_smoke.py A/B, PERF.md); what remains is still
// mostly the hot pages' serial atomics.
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

// One id and value per lane, the whole warp together.
__device__ __forceinline__ void add(float* acc, int k, float x, int segs,
                                    int lane) {
  const int key = (k >= 0 && k < segs) ? k : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  const float sum = reduce_peers(peers, key >= 0 ? x : 0.0f, lane);
  if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u)
    atomicAdd(&acc[key], sum);
}

// kVec: the row holds a multiple of 4 ids, so each lane loads 16 bytes of
// ids and 16 of values at a time. kShared: sum into shared memory first.
template <bool kVec, bool kShared>
__global__ void segsum_kernel(const int32_t* __restrict__ seg,
                              const float* __restrict__ val,
                              float* __restrict__ out, long long n,
                              int segs) {
  extern __shared__ float sh[];
  const int row = blockIdx.y;
  const int32_t* s = seg + static_cast<long long>(row) * n;
  const float* v = val + static_cast<long long>(row) * n;
  float* o = out + static_cast<long long>(row) * segs;
  float* acc = kShared ? sh : o;
  if (kShared) {
    for (int b = threadIdx.x; b < segs; b += blockDim.x) sh[b] = 0.0f;
    __syncthreads();
  }

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
      add(acc, k.x, x.x, segs, lane);
      add(acc, k.y, x.y, segs, lane);
      add(acc, k.z, x.z, segs, lane);
      add(acc, k.w, x.w, segs, lane);
    } else {
      int k = -1;
      float x = 0.0f;
      if (i < units) {
        k = __ldg(s + i);
        x = __ldg(v + i);
      }
      add(acc, k, x, segs, lane);
    }
  }

  if (kShared) {
    __syncthreads();
    // adding +0.0 to the zeroed output changes no bit, so zero bins skip
    for (int b = threadIdx.x; b < segs; b += blockDim.x) {
      const float c = sh[b];
      if (c != 0.0f) atomicAdd(&o[b], c);
    }
  }
}

template <bool kVec>
void launch(const int32_t* seg, const float* val, float* out, long long n,
            int rows, int segs, int sms, cudaStream_t stream) {
  const long long units = kVec ? n / 4 : n;
  long long want = (units + kThreads - 1) / kThreads;
  if (segs <= kSharedSegs) {
    // each block sums at least 8 * segs ids, so its flush of segs bins
    // stays a small share of the work
    const long long per = (n + 8LL * segs - 1) / (8LL * segs);
    if (per < want) want = per;
  }
  long long cap = (8LL * sms) / rows;
  if (cap < 1) cap = 1;
  const int per_row = static_cast<int>(want < 1 ? 1 : (want < cap ? want
                                                                  : cap));
  const dim3 grid(per_row, rows);
  if (segs <= kSharedSegs)
    segsum_kernel<kVec, true><<<grid, kThreads, segs * sizeof(float),
                                stream>>>(seg, val, out, n, segs);
  else
    segsum_kernel<kVec, false><<<grid, kThreads, 0, stream>>>(seg, val, out,
                                                              n, segs);
}

}  // namespace

extern "C" int thrill_segment_sum(const int32_t* seg, const float* val,
                                  float* out, long long n, int rows, int segs,
                                  int sms, cudaStream_t stream) {
  if (n > 0 && rows > 0 && segs > 0) {
    // rows start 16-byte aligned when n % 4 == 0 (torch aligns the bases)
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(seg) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(val) % 16 == 0)
      launch<true>(seg, val, out, n, rows, segs, sms, stream);
    else
      launch<false>(seg, val, out, n, rows, segs, sms, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
