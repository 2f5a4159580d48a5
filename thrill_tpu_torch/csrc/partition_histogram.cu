// Batched partition histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel partition_histogram_pallas
// (thrill_tpu/core/pallas_kernels.py:116, kernel _hist_kernel :94).
// out[r, b] = #{i : dest[r, i] == b} for b in [0, bins); other ids (the
// invalid rows' sentinel W, negative ids, int64 ids beyond 32 bits) are
// not counted: an id is tested against [0, bins) at its full width.
//
// Bound on this card: device memory. The kernel reads each id once, in
// the dtype its caller holds (int32 or int64: no copy before it), and
// writes rows * bins counters.
//
// Design. Each block keeps a shared-memory histogram of its share of a
// row and adds it to the zeroed `out` with one atomic per non-zero bin.
// Lanes load 16 bytes of ids at a time. A warp whose ids are all equal
// adds once: the main path (every exchange's send counts, W bins over
// destinations sorted per row with the sentinel run at each row's tail)
// is almost all such runs. Per-lane register counters summed by each
// row's last block (no zeroing launch) were 2-3 % slower on the main
// path's int64 inputs (PERF.md).
//
// The caller allocates `out` (zeroed) and passes its stream.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 16 bytes of ids: four int32 or two int64
template <typename T>
using Vec = typename std::conditional<sizeof(T) == 8, longlong2, int4>::type;

template <typename T>
constexpr int kPerVec = 16 / sizeof(T);

template <typename F>
__device__ __forceinline__ void each(const int4& v, F f) {
  f(v.x); f(v.y); f(v.z); f(v.w);
}

template <typename F>
__device__ __forceinline__ void each(const longlong2& v, F f) {
  f(v.x); f(v.y);
}

template <typename T>
__device__ __forceinline__ Vec<T> no_ids();

template <>
__device__ __forceinline__ int4 no_ids<int32_t>() {
  return make_int4(-1, -1, -1, -1);
}

template <>
__device__ __forceinline__ longlong2 no_ids<long long>() {
  return make_longlong2(-1, -1);
}

// The id's bin in [0, bins), or -1: an unsigned compare at full width
template <typename T>
__device__ __forceinline__ int bin_of(T v, int bins) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<U>(v) < static_cast<U>(bins) ? static_cast<int>(v) : -1;
}

// Adds the warp's bins (key -1: no bin) to the shared histogram. A warp
// whose keys are all equal adds once.
__device__ __forceinline__ void count(int32_t* sh, int key, int lane) {
  const int key0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == key0)) {
    if (lane == 0 && key0 >= 0) atomicAdd(&sh[key0], 32);
  } else if (key >= 0) {
    atomicAdd(&sh[key], 1);
  }
}

// A shared histogram per block, added to the zeroed `out`
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    hist_shared_kernel(const T* __restrict__ dest, int32_t* __restrict__ out,
                       long long n, int bins) {
  extern __shared__ int32_t shared_hist[];
  int32_t* hist = shared_hist;
  const int row = blockIdx.y;
  const T* d = dest + static_cast<long long>(row) * n;
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long units = kVec ? n / kPerVec<T> : n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // `base` is the same for all lanes of a warp, so every lane takes part
  // in the match even on the ragged tail (out-of-range lanes carry -1)
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads +
                        (threadIdx.x & ~31);
       base < units; base += stride) {
    const long long i = base + lane;
    if (kVec) {
      const Vec<T> v = i < units
                           ? __ldg(reinterpret_cast<const Vec<T>*>(d) + i)
                           : no_ids<T>();
      each(v, [&](auto x) { count(hist, bin_of(x, bins), lane); });
    } else {
      count(hist, i < units ? bin_of(__ldg(d + i), bins) : -1, lane);
    }
  }
  __syncthreads();

  int32_t* o = out + static_cast<long long>(row) * bins;
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    const int32_t c = hist[b];
    if (c) atomicAdd(&o[b], c);
  }
}

template <typename T>
void launch(const T* dest, int32_t* out, long long n, int rows, int bins,
            int blocks_per_row, cudaStream_t stream) {
  const dim3 grid(blocks_per_row, rows);
  const size_t smem = bins * sizeof(int32_t);
  // rows start 16-byte aligned when n fills whole vectors (torch aligns
  // the base)
  if (n % kPerVec<T> == 0 && reinterpret_cast<uintptr_t>(dest) % 16 == 0)
    hist_shared_kernel<T, true><<<grid, kThreads, smem, stream>>>(dest, out,
                                                                 n, bins);
  else
    hist_shared_kernel<T, false><<<grid, kThreads, smem, stream>>>(dest, out,
                                                                  n, bins);
}

}  // namespace

// dest: [rows, n] ids of id_bytes (4: int32, 8: int64); out: [rows, bins]
// zeros.
extern "C" int thrill_partition_histogram(const void* dest, int id_bytes,
                                          int32_t* out, long long n,
                                          int rows, int bins,
                                          int blocks_per_row,
                                          cudaStream_t stream) {
  if (rows > 0) {
    if (id_bytes == 8)
      launch(static_cast<const long long*>(dest), out, n, rows, bins,
             blocks_per_row, stream);
    else
      launch(static_cast<const int32_t*>(dest), out, n, rows, bins,
             blocks_per_row, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
