// Ordered segment sum for Hopper (sm_90a): every run folded left to
// right, in operand order.
//
// No TPU kernel of the reference package is replaced. This is the port's
// counterpart of XLA's ordered scatter-add: the reference folds every
// float "sum" outside the f32 segment-sum kernel with `.at[pos].add`
// (thrill_tpu/api/ops/reduce.py:921-922) or `jax.ops.segment_sum`
// (thrill_tpu/core/segmented.py:187-198), which XLA applies in operand
// order. CUDA's index_add_ adds with atomics in an order that changes
// from run to run; this kernel gives the same bits on every run, equal to
// the sequential scatter on the CPU.
//
// out[s, c] = (((+0.0 + v[r0, c]) + v[r1, c]) + ...) over the rows r0 <
// r1 < ... of run s: the rows order[offsets[s]] .. order[offsets[s+1] -
// 1] (or offsets[s] .. offsets[s+1] - 1 without an order). Values are
// [T, C] row-major, f32, f64, f16 or bf16; a half sum rounds after every
// add (float add, then round: what the CPU's scatter does).
//
// Bound on this card: a run's fold is one chain of dependent adds, so the
// hottest run sets a floor of (its rows) x (the add's latency), whatever
// the bandwidth; the rest is reading each value once through the order
// (bytes). Design, two launches on the caller's stream:
//   * small_runs: each warp takes runs in turn; a run of at most 256
//     elements (rows x columns) is loaded by the lanes together into the
//     warp's shared tile, then lane c folds column c. A longer run's id
//     goes to a list (an atomic counter);
//   * big_runs: each listed run is one block's (a block a run while the
//     list is shorter than the grid): tiles of 2048 elements
//     are loaded by all 256 threads, 8 loads in flight a thread, double
//     buffered in shared memory, while the first C threads fold the tile
//     before; the values of tile t+1 and the order of tile t+2 are loaded
//     during the fold of tile t (no load waits on another), so the chain
//     of adds, not the gathers, sets the pace, and the hot runs fold side
//     by side on their own SMs.
// Neighbouring lanes read neighbouring columns of one row, so a row of C
// columns is read coalesced. Columns come in chunks of 32 (grid.y).
//
// The caller allocates `out` [S, C] (every run is written, empty ones
// with +0.0), a zeroed int32 counter and an int64 list of S entries, and
// passes its stream.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerThread = 8;                        // loads in flight
constexpr int kWarpTile = 32 * kPerThread;           // 256 elements
constexpr int kBlockTile = kThreads * kPerThread;    // 2048 elements
constexpr int kChunk = 32;                           // columns a grid.y

template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __float2half_rn(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// One add of the fold, rounded to T: plain for f32 and f64 (nvcc neither
// reassociates nor contracts a lone add), through f32 for the halves.
template <typename T>
__device__ __forceinline__ T add(T a, T b) { return a + b; }
template <>
__device__ __forceinline__ __half add<__half>(__half a, __half b) {
  return __float2half_rn(__half2float(a) + __half2float(b));
}
template <>
__device__ __forceinline__ __nv_bfloat16 add<__nv_bfloat16>(
    __nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T>
__device__ __forceinline__ T load(const T* __restrict__ v,
                                  const int64_t* __restrict__ order,
                                  int64_t pos, int64_t C, int c) {
  const int64_t row = order ? order[pos] : pos;
  return v[row * C + c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    small_runs(const T* __restrict__ v, const int64_t* __restrict__ order,
               const int64_t* __restrict__ offsets, T* __restrict__ out,
               int64_t S, int64_t C, int* __restrict__ nbig,
               int64_t* __restrict__ big) {
  // raw bytes: the half types have constructors, which __shared__ refuses
  __shared__ __align__(16) unsigned char raw[kWarps * kWarpTile * sizeof(T)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kChunk;
  const int cw = static_cast<int>(C - c0 < kChunk ? C - c0 : kChunk);
  T* wbuf = reinterpret_cast<T*>(raw) + warp * kWarpTile;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp; s < S;
       s += step) {
    const int64_t lo = offsets[s];
    const int64_t n = offsets[s + 1] - lo;
    if (n * cw > kWarpTile) {
      if (lane == 0 && blockIdx.y == 0) big[atomicAdd(nbig, 1)] = s;
      continue;
    }
    const int elems = static_cast<int>(n) * cw;
    T vals[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int f = lane + 32 * u;
      if (f < elems) {
        const int r = f / cw;
        vals[u] = load(v, order, lo + r, C, c0 + f - r * cw);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int f = lane + 32 * u;
      if (f < elems) wbuf[f] = vals[u];
    }
    __syncwarp();
    if (lane < cw) {
      T acc = zero<T>();
      for (int r = 0; r < static_cast<int>(n); ++r)
        acc = add(acc, wbuf[r * cw + lane]);
      out[s * C + c0 + lane] = acc;
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    big_runs(const T* __restrict__ v, const int64_t* __restrict__ order,
             const int64_t* __restrict__ offsets, T* __restrict__ out,
             int64_t C, const int* __restrict__ nbig,
             const int64_t* __restrict__ big) {
  __shared__ __align__(16) unsigned char raw[2 * kBlockTile * sizeof(T)];
  T* buf = reinterpret_cast<T*>(raw);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int cw = static_cast<int>(C - c0 < kChunk ? C - c0 : kChunk);
  const int rows = kBlockTile / cw;                  // rows a tile
  const int count = *nbig;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int64_t t = big[i];
    const int64_t lo = offsets[t];
    const int64_t n = offsets[t + 1] - lo;
    const int64_t tiles = (n + rows - 1) / rows;
    // a thread's elements of a tile: its rows (read through the order a
    // tile ahead of the values, so that no load waits on another) and
    // its values
    int64_t rix[kPerThread];
    T vals[kPerThread];
    auto rows_of = [&](int64_t k, int64_t* dst) {
      const int64_t r0 = k * rows;
      const int64_t left = n - r0;
      const int elems = static_cast<int>(left < rows ? left : rows) * cw;
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int f = tid + kThreads * u;
        if (f < elems) {
          const int64_t pos = lo + r0 + f / cw;
          dst[u] = order ? order[pos] : pos;
        }
      }
      return elems;
    };
    auto fetch = [&](int elems) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int f = tid + kThreads * u;
        if (f < elems) vals[u] = v[rix[u] * C + c0 + f % cw];
      }
    };
    auto stash = [&](int elems, T* dst) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int f = tid + kThreads * u;
        if (f < elems) dst[f] = vals[u];
      }
    };
    int next = rows_of(0, rix);
    fetch(next);
    stash(next, buf);
    next = tiles > 1 ? rows_of(1, rix) : 0;
    __syncthreads();
    T acc = zero<T>();
    for (int64_t k = 0; k < tiles; ++k) {
      const bool more = k + 1 < tiles;
      // in flight during the fold: tile k+1's values, tile k+2's rows
      if (more) fetch(next);
      int64_t rix2[kPerThread];
      const int after = k + 2 < tiles ? rows_of(k + 2, rix2) : 0;
      if (tid < cw) {
        const T* b = buf + (k & 1) * kBlockTile + tid;
        const int64_t left = n - k * rows;
        const int nr = static_cast<int>(left < rows ? left : rows);
        int r = 0;
        // eight values read ahead of their adds: only the adds chain
        for (; r + 8 <= nr; r += 8) {
          T x[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = b[(r + j) * cw];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc = add(acc, x[j]);
        }
        for (; r < nr; ++r) acc = add(acc, b[r * cw]);
      }
      if (more) stash(next, buf + ((k + 1) & 1) * kBlockTile);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) rix[u] = rix2[u];
      next = after;
      __syncthreads();
    }
    if (tid < cw) out[t * C + c0 + tid] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* v, const int64_t* order,
                   const int64_t* offsets, void* out, long long S,
                   long long C, int* nbig, int64_t* big, int small_blocks,
                   int big_blocks, cudaStream_t stream) {
  const unsigned chunks = static_cast<unsigned>((C + kChunk - 1) / kChunk);
  small_runs<T><<<dim3(small_blocks, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(v), order, offsets, static_cast<T*>(out), S, C,
      nbig, big);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  big_runs<T><<<dim3(big_blocks, chunks), kThreads, 0, stream>>>(
      static_cast<const T*>(v), order, offsets, static_cast<T*>(out), C,
      nbig, big);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 f64, 2 f16, 3 bf16. order may be null (rows already in
// runs). nbig: a zeroed int32; big: S int64 of scratch. Returns the
// launches' cudaError_t.
extern "C" int thrill_ordered_segment_sum(const void* values, int dtype,
                                          const int64_t* order,
                                          const int64_t* offsets, void* out,
                                          long long S, long long C, int* nbig,
                                          int64_t* big, int small_blocks,
                                          int big_blocks,
                                          cudaStream_t stream) {
  if (S <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(values, order, offsets, out, S,
                                            C, nbig, big, small_blocks,
                                            big_blocks, stream));
    case 1:
      return static_cast<int>(launch<double>(values, order, offsets, out, S,
                                             C, nbig, big, small_blocks,
                                             big_blocks, stream));
    case 2:
      return static_cast<int>(launch<__half>(values, order, offsets, out, S,
                                             C, nbig, big, small_blocks,
                                             big_blocks, stream));
    case 3:
      return static_cast<int>(launch<__nv_bfloat16>(
          values, order, offsets, out, S, C, nbig, big, small_blocks,
          big_blocks, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
