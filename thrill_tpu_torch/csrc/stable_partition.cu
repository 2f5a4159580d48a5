// Batched stable partition offsets for Hopper (sm_90a).
//
// Replaces the TPU kernel stable_partition_offsets_pallas
// (thrill_tpu/core/pallas_sort.py:85, kernel _part_kernel :50).
// For every row r: offsets[r, i] = base[d_i] + #{j < i : d_j == d_i}, where
// d is dest sanitised into [0, bins] (ids outside [0, bins) go to the
// trailing sentinel bin `bins`) and base is the exclusive prefix of the
// row's histogram. The result is always a permutation of [0, n).
//
// Bound on this card: device memory. Each id is read twice (once to
// count, once to rank) and each offset written once; the per-tile count
// array adds (bins + 1) * 4 bytes per kTile ids (about 0.25 bytes per id
// at 256 bins), read and written a few times by the scans.
//
// The TPU kernel relied on an in-order grid carrying per-digit counters
// in VMEM and an MXU triangular matmul for the within-tile prefix. Blocks
// here run in parallel and in no order, so the work is split:
//   1. tile_counts: per-tile digit counts into counts[r, b, t] (shared-
//      memory atomics; a warp of equal digits adds once);
//   2. an exclusive scan of counts[r] in (bin, tile) order, which gives
//      every tile its start per digit, in two launches: bin_scan scans
//      each bin's tiles (one block per bin and row) and leaves the bin's
//      total; base_scan turns the totals into each bin's base;
//   3. rank: each warp owns 128 consecutive ids of a tile. A lane's rank
//      among equal digits of its 32 ids is __match_any_sync + __popc of
//      the lower lanes, plus the warp's count of that digit in its
//      earlier steps (kept in shared memory). The per-warp counts are
//      then scanned over the tile's warps, seeded with the tile's start,
//      and the kernel writes the offsets.
//
// The caller allocates `scratch` (thrill_stable_partition_scratch() int32
// values) and `out` and passes its stream; nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps; the scans below assume this
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;       // ids per lane in a tile
constexpr int kTile = kThreads * kSteps;

__device__ __forceinline__ int sanitize(int v, int bins) {
  return (v >= 0 && v < bins) ? v : bins;
}

// Exclusive scan of one value per thread over the block; every thread
// gets the block total. Uses `tmp` (kWarps + 1 ints of shared memory).
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x,
                                                        int32_t* tmp,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t s = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) tmp[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = tmp[lane];
    int32_t ws = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    tmp[lane] = ws - w;
    if (lane == 31) tmp[kWarps] = ws;
  }
  __syncthreads();
  const int32_t r = tmp[warp] + s - x;
  *total = tmp[kWarps];
  __syncthreads();  // tmp is reused by the caller's next scan
  return r;
}

__global__ void tile_counts_kernel(const int32_t* __restrict__ dest,
                                   int32_t* __restrict__ counts, long long n,
                                   int bins, long long tiles) {
  extern __shared__ int32_t sh[];  // [bins + 1]
  const int nb = bins + 1;
  const int row = blockIdx.y;
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int32_t* d = dest + static_cast<long long>(row) * n;
  int key[kSteps];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const long long i = t * kTile + q * kThreads + threadIdx.x;
    key[q] = i < n ? sanitize(__ldg(d + i), bins) : -1;
  }
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    // a warp of equal digits adds once; otherwise every lane adds
    const int key0 = __shfl_sync(0xffffffffu, key[q], 0);
    if (__all_sync(0xffffffffu, key[q] == key0)) {
      if (lane == 0 && key0 >= 0) atomicAdd(&sh[key0], 32);
    } else if (key[q] >= 0) {
      atomicAdd(&sh[key[q]], 1);
    }
  }
  __syncthreads();

  int32_t* c = counts + static_cast<long long>(row) * nb * tiles;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) c[b * tiles + t] = sh[b];
}

// grid (bins + 1, rows): exclusive scan of counts[r, b, :] in place;
// totals[r, b] = the bin's count over the row
__global__ void bin_scan_kernel(int32_t* __restrict__ counts,
                                int32_t* __restrict__ totals,
                                long long tiles) {
  __shared__ int32_t tmp[kWarps + 1];
  const long long rb = static_cast<long long>(blockIdx.y) * gridDim.x +
                       blockIdx.x;
  int32_t* c = counts + rb * tiles;
  int32_t carry = 0;  // the same running total in every thread
  for (long long base = 0; base < tiles; base += kThreads) {
    const long long i = base + threadIdx.x;
    int32_t total;
    const int32_t x = i < tiles ? c[i] : 0;
    const int32_t e = block_exclusive_scan(x, tmp, &total);
    if (i < tiles) c[i] = carry + e;
    carry += total;
  }
  if (threadIdx.x == 0) totals[rb] = carry;
}

// grid (rows): totals[r, :] -> exclusive prefix in place (bins + 1 <= 1024)
__global__ void base_scan_kernel(int32_t* __restrict__ totals, int nb) {
  __shared__ int32_t tmp[kWarps + 1];
  int32_t* t = totals + static_cast<long long>(blockIdx.x) * nb;
  int32_t total;
  const int32_t x = threadIdx.x < nb ? t[threadIdx.x] : 0;
  const int32_t e = block_exclusive_scan(x, tmp, &total);
  if (threadIdx.x < nb) t[threadIdx.x] = e;
}

__global__ void rank_kernel(const int32_t* __restrict__ dest,
                            const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ base,
                            int32_t* __restrict__ out, long long n, int bins,
                            long long tiles) {
  extern __shared__ int32_t sh[];
  const int nb = bins + 1;
  int32_t* start = sh;         // [nb]: the tile's first offset per digit
  int32_t* wc = sh + nb;       // [kWarps][nb]: per-warp digit counts
  const int row = blockIdx.y;
  const long long t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  const int32_t* s = starts + static_cast<long long>(row) * nb * tiles;
  const int32_t* bs = base + static_cast<long long>(row) * nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    start[b] = bs[b] + s[b * tiles + t];
  for (int j = threadIdx.x; j < kWarps * nb; j += blockDim.x) wc[j] = 0;

  const int32_t* d = dest + static_cast<long long>(row) * n;
  const long long w0 = t * kTile + warp * (32 * kSteps);
  int key[kSteps];
  int rank[kSteps];
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const long long i = w0 + q * 32 + lane;
    key[q] = i < n ? sanitize(__ldg(d + i), bins) : -1;
  }
  __syncthreads();

  int32_t* mine = wc + warp * nb;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
    const int below = __popc(peers & lanes_below);
    const int before = key[q] >= 0 ? mine[key[q]] : 0;
    __syncwarp();
    if (key[q] >= 0 && below == 0) mine[key[q]] = before + __popc(peers);
    __syncwarp();
    rank[q] = before + below;
  }
  __syncthreads();

  // per digit: exclusive scan over the tile's warps, seeded with the start
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int32_t acc = start[b];
    for (int w = 0; w < kWarps; ++w) {
      const int32_t v = wc[w * nb + b];
      wc[w * nb + b] = acc;
      acc += v;
    }
  }
  __syncthreads();

  int32_t* o = out + static_cast<long long>(row) * n;
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    if (key[q] >= 0) o[w0 + q * 32 + lane] = mine[key[q]] + rank[q];
  }
}

}  // namespace

// int32 values of scratch the wrapper allocates for n ids in `rows` rows
extern "C" long long thrill_stable_partition_scratch(long long n, int rows,
                                                     int bins) {
  const long long tiles = (n + kTile - 1) / kTile;
  return static_cast<long long>(rows) * (bins + 1) * (tiles + 1);
}

extern "C" int thrill_stable_partition_offsets(const int32_t* dest,
                                               int32_t* scratch, int32_t* out,
                                               long long n, int rows, int bins,
                                               cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = (n + kTile - 1) / kTile;
  const int nb = bins + 1;
  int32_t* counts = scratch;                                  // [rows, nb, tiles]
  int32_t* totals = scratch + static_cast<long long>(rows) * nb * tiles;  // [rows, nb]
  const dim3 grid(static_cast<unsigned>(tiles), rows);
  tile_counts_kernel<<<grid, kThreads, nb * sizeof(int32_t), stream>>>(
      dest, counts, n, bins, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_scan_kernel<<<dim3(nb, rows), kThreads, 0, stream>>>(counts, totals,
                                                           tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  base_scan_kernel<<<rows, kThreads, 0, stream>>>(totals, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_kernel<<<grid, kThreads, (1 + kWarps) * nb * sizeof(int32_t), stream>>>(
      dest, counts, totals, out, n, bins, tiles);
  return static_cast<int>(cudaGetLastError());
}
