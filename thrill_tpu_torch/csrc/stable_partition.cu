// Onesweep radix engine and batched stable-partition offsets for Hopper
// (sm_90a).
//
// Replaces the TPU kernel stable_partition_offsets_pallas
// (thrill_tpu/core/pallas_sort.py:85, kernel _part_kernel :50) and, in the
// radix driver radix_argsort_device (:161), the digit extraction and the
// scatter of the permutation that surround it in every pass.
//
// The TPU kernel computes, per row, offsets[i] = base[d_i] + #{j < i :
// d_j == d_i} over ids d sanitised into [0, bins] (ids outside [0, bins)
// go to the trailing sentinel bin `bins`), base being the exclusive prefix
// of the row's histogram; its driver scatters the permutation by those
// offsets once per 8-bit digit. Here the engine is a key-value LSD radix
// sort in the style of onesweep (Adinets and Merrill, 2022):
//
//   * upsweep (one launch per key word): reads the int64 word once with
//     16-byte loads and counts all its byte-digits into shared-memory
//     histograms, int32 [rows, 8, 256]. A digit's histogram does not
//     depend on the row order, so these give every pass its global digit
//     base, and the driver its pass liveness, before the first pass runs.
//   * pass (one launch per live digit): a block takes the next tile from
//     an atomic counter, so that every tile it waits on belongs to a
//     block that already runs or is done. It loads the tile's keys and
//     permutation entries, ranks each key within the tile (a warp's lanes
//     with equal digits by one ballot per digit bit, per-warp digit counts
//     in shared memory, a scan across the warps), publishes the tile's
//     per-digit counts as an "aggregate", stages the tile sorted by digit
//     in shared memory, finds its exclusive per-digit prefix by decoupled
//     look-back over the earlier tiles of its row and publishes its
//     inclusive prefix, then writes keys and permutation entries so that
//     each digit's run goes out contiguously. The first pass of a word
//     reads the word through the incoming permutation while it loads (one
//     gather per word, fused into the pass); later passes of the word
//     carry (key, permutation) pairs.
//   * offsets: the same pass kernel with an epilogue that writes each
//     input row's target offset instead of scattering: the TPU kernel's
//     exact function, over up to 256 bins plus the sentinel. Its global
//     base comes from an id histogram of the sanitised ids.
//
// Status words are 64-bit: [epoch : 30 | flag : 2 | count : 32], so counts
// up to n <= 2^31 - 1 fit without packing limits. A flag is published with
// st.release.gpu and read with relaxed loads followed by an acquire
// fence. The driver zeroes one status array and one tile counter per pass
// for a whole argsort and gives each pass its own epoch, so no launch
// resets anything.
//
// Bound on this card: device memory. A pass over [rows, n] reads a key
// (8 bytes) and a permutation entry (4) per row and writes both: 24 bytes
// a row, 0.120 ms at [4, 2^22]. The upsweep reads 8 bytes a row. What the
// pass's design does about it (each step timed by kernel_times.py against
// the variant without it; PERF.md): every load of a tile goes out before
// the first use; ballots rank in a fixed number of steps, where
// __match_any_sync's cost grows with the distinct digits of a warp; keys
// are staged before the look-back, so that they leave the registers
// (two blocks share an SM), and the offsets epilogue, which stages
// nothing, runs four blocks an SM; the look-back reads kLookback status
// words at a time; a word's first pass deals tiles row by row, so that
// the row being read at random stays in L2, and other passes deal them
// round-robin over the rows, so that the rows' look-back chains advance
// side by side.
//
// The caller allocates every buffer (scratch zeroed) and passes its
// stream; nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // 8 warps; the scans assume it
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys per thread in a tile
constexpr int kTile = kThreads * kItems;   // 4096 keys
constexpr int kRadix = 256;
constexpr int kNbPad = kRadix + 8;         // 256 digits, or 256 bins + 1;
                                           // a thread owns two of them
constexpr u64 kAggregate = 1ull << 32;
constexpr u64 kInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
constexpr int kLookback = 8;               // status words read per step

// shared memory of the pass kernel: per-warp digit counts, digit
// shifts, scan scratch; then (radix passes only) the staging area
constexpr int kRankInts = kWarps * kNbPad + kNbPad + kWarps + 2;
constexpr size_t kRankBytes = ((kRankInts * 4 + 15) / 16) * 16;
constexpr size_t kStageBytes = static_cast<size_t>(kTile) * (8 + 4);

__device__ __forceinline__ int sanitize(int v, int bins) {
  return (v >= 0 && v < bins) ? v : bins;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// with the relaxed loads before it, an acquire of what they read
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Exclusive scan of one value per thread over the block; every thread
// gets the block total. Uses `tmp` (kWarps + 1 ints of shared memory).
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t x,
                                                        int32_t* tmp,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t s = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  if (lane == 31) tmp[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = lane < kWarps ? tmp[lane] : 0;
    int32_t ws = w;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < kWarps) tmp[lane] = ws - w;
    if (lane == kWarps - 1) tmp[kWarps] = ws;
  }
  __syncthreads();
  const int32_t r = tmp[warp] + s - x;
  *total = tmp[kWarps];
  __syncthreads();  // tmp is reused by the caller's next scan
  return r;
}

// Count one digit per lane into sh (d < 0: no key). A warp whose lanes
// all hold the same digit adds once: zero padding and the high bytes of
// small words are uniform, and their atomics would serialise.
__device__ __forceinline__ void count_digit(int32_t* sh, int d, int lane) {
  const int d0 = __shfl_sync(kFull, d, 0);
  if (__all_sync(kFull, d == d0)) {
    if (lane == 0 && d0 >= 0) atomicAdd(&sh[d0], 32);
  } else if (d >= 0) {
    atomicAdd(&sh[d], 1);
  }
}

// grid (blocks per row, rows): hist[r, j, b] += #{i : byte j of words[r,
// i] == b} for j < ndigits. kVec: the row holds an even number of words,
// 16-byte aligned, loaded two at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    upsweep_kernel(const u64* __restrict__ words, int32_t* __restrict__ hist,
                   long long n, int ndigits) {
  __shared__ int32_t sh[8 * kRadix];
  for (int j = threadIdx.x; j < 8 * kRadix; j += kThreads) sh[j] = 0;
  __syncthreads();
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const u64* w = words + static_cast<long long>(row) * n;
  const long long units = kVec ? n / 2 : n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // `base` is warp-uniform: every lane takes part in the warp votes
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads +
                        (threadIdx.x & ~31);
       base < units; base += stride) {
    const long long i = base + lane;
    const bool ok = i < units;
    u64 k0 = 0, k1 = 0;
    if (ok) {
      if (kVec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(w) + i);
        k0 = static_cast<u64>(v.x) | (static_cast<u64>(v.y) << 32);
        k1 = static_cast<u64>(v.z) | (static_cast<u64>(v.w) << 32);
      } else {
        k0 = __ldg(w + i);
      }
    }
    for (int j = 0; j < ndigits; ++j) {
      const int s = 8 * j;
      count_digit(sh + j * kRadix, ok ? static_cast<int>((k0 >> s) & 255u)
                                      : -1, lane);
      if (kVec)
        count_digit(sh + j * kRadix,
                    ok ? static_cast<int>((k1 >> s) & 255u) : -1, lane);
    }
  }
  __syncthreads();
  int32_t* h = hist + static_cast<long long>(row) * 8 * kRadix;
  for (int j = threadIdx.x; j < ndigits * kRadix; j += kThreads)
    if (sh[j]) atomicAdd(&h[j], sh[j]);
}

// grid (blocks per row, rows): hist[r, b] += #{i : sanitize(dest[r, i]) ==
// b} for b in [0, bins]: the offsets' global base.
__global__ void __launch_bounds__(kThreads)
    id_hist_kernel(const int32_t* __restrict__ dest,
                   int32_t* __restrict__ hist, long long n, int bins) {
  __shared__ int32_t sh[kNbPad];
  const int nb = bins + 1;
  for (int j = threadIdx.x; j < nb; j += kThreads) sh[j] = 0;
  __syncthreads();
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int32_t* d = dest + static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    count_digit(sh, i < n ? sanitize(__ldg(d + i), bins) : -1, lane);
  }
  __syncthreads();
  int32_t* h = hist + static_cast<long long>(row) * nb;
  for (int j = threadIdx.x; j < nb; j += kThreads)
    if (sh[j]) atomicAdd(&h[j], sh[j]);
}

__device__ __forceinline__ u64 status_word(u64 epoch, u64 flag, int count) {
  return (epoch << kEpochShift) | flag |
         static_cast<u64>(static_cast<uint32_t>(count));
}

// One launch: every tile of every row, one block per tile.
//
// kOffsets = false (a radix pass): keys_in is u64 [rows, n]: the carried
// keys, or with `gather` the word in its original row order, read at
// perm_in[i]; perm_in int32 [rows, n] or null for the identity. The pass
// writes the keys (unless keys_out is null) and the permutation, stably
// partitioned by the digit (key >> shift) & 255.
// kOffsets = true: keys_in is int32 dest [rows, n]; out[i] = the offset of
// row i under the sanitised ids, into perm_out.
// hist: the row's histogram, int32 with row stride hist_stride; entries
// [0, nb - 1) are read. status: [rows, tiles, nb] 64-bit words.
template <bool kOffsets>
__global__ void __launch_bounds__(kThreads, kOffsets ? 4 : 2)
    onesweep_kernel(const void* __restrict__ keys_in,
                    const int32_t* __restrict__ perm_in, int gather,
                    u64* __restrict__ keys_out, int32_t* __restrict__ perm_out,
                    const int32_t* __restrict__ hist, long long hist_stride,
                    u64* __restrict__ status, unsigned* __restrict__ counter,
                    long long n, int rows, long long tiles, int shift,
                    int bins, u64 epoch) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* wc = reinterpret_cast<int32_t*>(smem);  // [kWarps][kNbPad]
  int32_t* dshift = wc + kWarps * kNbPad;          // [kNbPad]
  int32_t* tmp = dshift + kNbPad;                  // [kWarps + 2]
  u64* skeys = reinterpret_cast<u64*>(smem + kRankBytes);  // [kTile]
  int32_t* sperm = reinterpret_cast<int32_t*>(skeys + kTile);

  const int nb = kOffsets ? bins + 1 : kRadix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tmp[kWarps + 1] = static_cast<int32_t>(
      atomicAdd(counter, 1u));
  for (int j = threadIdx.x; j < kWarps * kNbPad; j += kThreads) wc[j] = 0;
  __syncthreads();
  // tiles are dealt round-robin over the rows, so that the rows'
  // look-back chains advance side by side; but a word's first pass, which
  // reads the word at random through the permutation, goes row by row, so
  // that the row being read stays in L2 (32 MB at 2^22 keys)
  const long long g = static_cast<uint32_t>(tmp[kWarps + 1]);
  const bool by_row = gather && perm_in;
  const long long t = by_row ? g % tiles : g / rows;
  const int row = static_cast<int>(by_row ? g / tiles : g % rows);
  const long long roff = static_cast<long long>(row) * n;
  const long long wbase = t * kTile + warp * (32 * kItems);

  // load: lane l holds keys wbase + q * 32 + l, so a warp's keys are in
  // row order by (q, lane) and each load is 32 neighbouring elements. All
  // loads go out before the first use (predicated, not branched, so that
  // the compiler keeps them in flight together).
  const bool full = (t + 1) * kTile <= n;
  int dig[kItems];
  u64 key[kItems];
  int32_t pv[kItems];
  if (kOffsets) {
    const int32_t* d = static_cast<const int32_t*>(keys_in) + roff;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = wbase + q * 32 + lane;
      pv[q] = (full || i < n) ? __ldg(d + i) : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = wbase + q * 32 + lane;
      dig[q] = (full || i < n) ? sanitize(pv[q], bins) : -1;
    }
  } else {
    const u64* k = static_cast<const u64*>(keys_in) + roff;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = wbase + q * 32 + lane;
      pv[q] = (full || i < n) ? (perm_in ? __ldg(perm_in + roff + i)
                                         : static_cast<int32_t>(i))
                              : 0;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = wbase + q * 32 + lane;
      key[q] = (full || i < n) ? __ldg(k + ((gather && perm_in) ? pv[q] : i))
                               : 0ull;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = wbase + q * 32 + lane;
      dig[q] = (full || i < n) ? static_cast<int>((key[q] >> shift) & 255u)
                               : -1;
    }
  }

  // rank within the warp: the lanes of one step with equal digits (one
  // ballot per digit bit: a fixed cost, where __match_any_sync's grows
  // with the distinct digits, and was 0.05 ms a pass slower at [4, 2^22]),
  // plus the warp's count of that digit so far
  int32_t* mine = wc + warp * kNbPad;
  const unsigned lanes_below = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    unsigned peers = __ballot_sync(kFull, dig[q] >= 0);
#pragma unroll
    for (int bit = 0; bit < (kOffsets ? 9 : 8); ++bit) {
      const unsigned set = __ballot_sync(kFull, (dig[q] >> bit) & 1);
      peers &= ((dig[q] >> bit) & 1) ? set : ~set;
    }
    const int below = __popc(peers & lanes_below);
    const int before = dig[q] >= 0 ? mine[dig[q]] : 0;
    __syncwarp();
    if (dig[q] >= 0 && below == 0) mine[dig[q]] = before + __popc(peers);
    __syncwarp();
    rank[q] = before + below;
  }
  __syncthreads();

  // thread b owns digits b and b + kThreads: the per-warp counts become
  // exclusive prefixes over the warps, and the tile's count is published
  // at once, so that later tiles can look back past this one
  u64* st = status + static_cast<long long>(row) * tiles * nb;
  int cnt[2] = {0, 0};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int b = threadIdx.x + s * kThreads;
    if (b < nb) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int v = wc[w * kNbPad + b];
        wc[w * kNbPad + b] = acc;
        acc += v;
      }
      cnt[s] = acc;
      st_release(st + t * nb + b,
                 status_word(epoch, t == 0 ? kInclusive : kAggregate, acc));
    }
  }

  // tile start of each digit, and the row's global base of each digit
  int32_t total;
  int32_t start[2], base[2];
  start[0] = block_exclusive_scan(cnt[0], tmp, &total);
  const int32_t* h = hist + static_cast<long long>(row) * hist_stride;
  const int h0 = threadIdx.x < nb - 1 ? __ldg(h + threadIdx.x) : 0;
  int32_t htotal;
  base[0] = block_exclusive_scan(h0, tmp, &htotal);
  start[1] = base[1] = 0;
  if (nb > kThreads) {  // the offsets' sentinel bin
    int32_t unused;
    start[1] = total + block_exclusive_scan(cnt[1], tmp, &unused);
    const int b1 = threadIdx.x + kThreads;
    base[1] = htotal + block_exclusive_scan(b1 < nb - 1 ? __ldg(h + b1) : 0,
                                            tmp, &unused);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int b = threadIdx.x + s * kThreads;
    if (b < nb) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) wc[w * kNbPad + b] += start[s];
    }
  }
  __syncthreads();

  // each key's position in the tile sorted by digit; a radix pass stages
  // the sorted tile in shared memory now, before the look-back, so that
  // its keys leave the registers
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (dig[q] >= 0) {
      rank[q] += mine[dig[q]];
      if (!kOffsets) {
        skeys[rank[q]] = key[q];
        sperm[rank[q]] = pv[q];
      }
    }
  }

  // decoupled look-back per digit over the earlier tiles of the row,
  // kLookback status words at a time with relaxed loads and one acquire
  // fence: summing the aggregates of tiles in flight costs one round
  // trip per kLookback tiles, not per tile
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int b = threadIdx.x + s * kThreads;
    if (b < nb) {
      int excl = 0;
      if (t > 0) {
        long long p = t - 1;
        bool done = false;
        while (!done) {
          u64 v[kLookback];
#pragma unroll
          for (int j = 0; j < kLookback; ++j)
            v[j] = p - j >= 0 ? ld_relaxed(st + (p - j) * nb + b) : 0ull;
          fence_acquire();
          int j = 0;
          // tile 0 is inclusive, so the walk never passes it
          for (; j < kLookback; ++j) {
            if ((v[j] >> kEpochShift) != epoch) break;  // not published yet
            excl += static_cast<int>(static_cast<uint32_t>(v[j]));
            if (v[j] & kInclusive) {
              done = true;
              break;
            }
          }
          p -= j;  // resume at the first tile not yet published
        }
        st_release(st + t * nb + b,
                   status_word(epoch, kInclusive, excl + cnt[s]));
      }
      dshift[b] = base[s] + excl - start[s];
    }
  }
  __syncthreads();

  if (kOffsets) {
    int32_t* o = perm_out + roff;
#pragma unroll
    for (int q = 0; q < kItems; ++q)
      if (dig[q] >= 0) o[wbase + q * 32 + lane] = dshift[dig[q]] + rank[q];
    return;
  }

  // write each digit's run of the sorted tile
  const long long left = n - t * kTile;
  const int valid = left < kTile ? static_cast<int>(left) : kTile;
  for (int i = threadIdx.x; i < valid; i += kThreads) {
    const u64 k = skeys[i];
    const long long pos =
        roff + dshift[static_cast<int>((k >> shift) & 255u)] + i;
    if (keys_out) keys_out[pos] = k;
    perm_out[pos] = sperm[i];
  }
}

template <bool kOffsets>
cudaError_t launch_pass(const void* keys_in, const int32_t* perm_in,
                        int gather, u64* keys_out, int32_t* perm_out,
                        const int32_t* hist, long long hist_stride,
                        u64* status, unsigned* counter, long long n, int rows,
                        int shift, int bins, u64 epoch, cudaStream_t stream) {
  const size_t smem = kRankBytes + (kOffsets ? 0 : kStageBytes);
  const cudaError_t e = cudaFuncSetAttribute(
      onesweep_kernel<kOffsets>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long tiles = (n + kTile - 1) / kTile;
  onesweep_kernel<kOffsets><<<static_cast<unsigned>(tiles * rows), kThreads,
                              smem, stream>>>(
      keys_in, perm_in, gather, keys_out, perm_out, hist, hist_stride, status,
      counter, n, rows, tiles, shift, bins, epoch);
  return cudaGetLastError();
}

}  // namespace

// hist (zeroed int32 [rows, 8, 256]) += the byte-digit histograms of the
// first ndigits digits of words (int64 [rows, n])
extern "C" int thrill_radix_upsweep(const u64* words, int32_t* hist,
                                    long long n, int rows, int ndigits,
                                    int per_row, cudaStream_t stream) {
  if (n > 0 && rows > 0 && ndigits > 0) {
    const dim3 grid(per_row, rows);
    if (n % 2 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0)
      upsweep_kernel<true><<<grid, kThreads, 0, stream>>>(words, hist, n,
                                                          ndigits);
    else
      upsweep_kernel<false><<<grid, kThreads, 0, stream>>>(words, hist, n,
                                                           ndigits);
  }
  return static_cast<int>(cudaGetLastError());
}

// One radix pass; see onesweep_kernel. status and counter belong to the
// caller's argsort: zeroed once, `epoch` (from 1) distinct per pass.
extern "C" int thrill_radix_pass(const u64* keys_in, const int32_t* perm_in,
                                 int gather, u64* keys_out, int32_t* perm_out,
                                 const int32_t* hist, long long hist_stride,
                                 u64* status, unsigned* counter, long long n,
                                 int rows, int shift, long long epoch,
                                 cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch_pass<false>(
      keys_in, perm_in, gather, keys_out, perm_out, hist, hist_stride, status,
      counter, n, rows, shift, kRadix - 1, static_cast<u64>(epoch), stream));
}

// 64-bit words of zeroed scratch for the offsets of n ids in rows rows
extern "C" long long thrill_stable_partition_scratch(long long n, int rows,
                                                     int bins) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long nb = bins + 1;
  return rows * tiles * nb + (rows * nb + 1) / 2 + 1;
}

// out[r, i] = stable-partition offset of dest[r, i]: the id histogram,
// then the pass kernel's offsets epilogue. scratch: zeroed,
// thrill_stable_partition_scratch() 64-bit words.
extern "C" int thrill_stable_partition_offsets(const int32_t* dest,
                                               u64* scratch, int32_t* out,
                                               long long n, int rows, int bins,
                                               int per_row,
                                               cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  if (bins + 1 > kNbPad)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + kTile - 1) / kTile;
  const int nb = bins + 1;
  u64* status = scratch;
  int32_t* hist = reinterpret_cast<int32_t*>(scratch + rows * tiles * nb);
  unsigned* counter = reinterpret_cast<unsigned*>(
      scratch + rows * tiles * nb + (static_cast<long long>(rows) * nb + 1) / 2);
  id_hist_kernel<<<dim3(per_row, rows), kThreads, 0, stream>>>(dest, hist, n,
                                                              bins);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_pass<true>(
      dest, nullptr, 0, nullptr, out, hist, nb, status, counter, n, rows, 0,
      bins, 1ull, stream));
}
