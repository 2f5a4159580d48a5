// Batched partition histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel partition_histogram_pallas
// (thrill_tpu/core/pallas_kernels.py:116, kernel _hist_kernel :94).
// out[r, b] = #{i : dest[r, i] == b} for b in [0, bins); ids outside that
// range (padding sentinels, e.g. W for invalid rows) are not counted.
//
// Bound on this card: device memory. The kernel reads each int32 id once
// and writes rows * bins counters, so 4 bytes per id is the whole cost.
// Design: a grid-stride walk per row in which each lane loads 16 bytes
// (four ids) at a time when the row allows it, so enough bytes are in
// flight; lanes add to a shared-memory histogram, and a warp whose 32
// ids are equal adds once (uniform digits and sorted destinations do not
// serialise on one shared address); each block then adds its non-zero
// bins to the global [rows, bins] output with atomics. The TPU kernel
// carried an f32 one-hot sum across a sequential grid; here counters are
// int32 from the start, so the 2^24-row f32 gate is gone and the wrapper
// refuses only n >= 2^31.
//
// The caller zeroes `out`, allocates everything, and passes its stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Adds the warp's ids to the shared histogram. A warp whose ids are all
// equal (uniform digits, sorted destinations) adds once; otherwise each
// lane adds its own id.
__device__ __forceinline__ void count(int32_t* sh, int v, int bins,
                                      int lane) {
  const int key = (v >= 0 && v < bins) ? v : -1;
  const int key0 = __shfl_sync(0xffffffffu, key, 0);
  if (__all_sync(0xffffffffu, key == key0)) {
    if (lane == 0 && key0 >= 0) atomicAdd(&sh[key0], 32);
  } else if (key >= 0) {
    atomicAdd(&sh[key], 1);
  }
}

// kVec: the row holds a multiple of 4 ids, so each lane loads an int4
template <bool kVec>
__global__ void hist_kernel(const int32_t* __restrict__ dest,
                            int32_t* __restrict__ out, long long n,
                            int bins) {
  extern __shared__ int32_t sh[];
  const int row = blockIdx.y;
  const int32_t* d = dest + static_cast<long long>(row) * n;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) sh[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long units = kVec ? n / 4 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // `base` is the same for all lanes of a warp, so every lane takes part
  // in the match even on the ragged tail (out-of-range lanes carry -1)
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < units; base += stride) {
    const long long i = base + lane;
    if (kVec) {
      int4 v = make_int4(-1, -1, -1, -1);
      if (i < units) v = __ldg(reinterpret_cast<const int4*>(d) + i);
      count(sh, v.x, bins, lane);
      count(sh, v.y, bins, lane);
      count(sh, v.z, bins, lane);
      count(sh, v.w, bins, lane);
    } else {
      count(sh, i < units ? __ldg(d + i) : -1, bins, lane);
    }
  }
  __syncthreads();

  int32_t* o = out + static_cast<long long>(row) * bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    const int32_t c = sh[b];
    if (c) atomicAdd(&o[b], c);
  }
}

}  // namespace

extern "C" int thrill_partition_histogram(const int32_t* dest, int32_t* out,
                                          long long n, int rows, int bins,
                                          int blocks_per_row,
                                          cudaStream_t stream) {
  if (n > 0 && rows > 0) {
    const dim3 grid(blocks_per_row, rows);
    const size_t smem = bins * sizeof(int32_t);
    // rows start 16-byte aligned when n % 4 == 0 (torch aligns the base)
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(dest) % 16 == 0)
      hist_kernel<true><<<grid, kThreads, smem, stream>>>(dest, out, n, bins);
    else
      hist_kernel<false><<<grid, kThreads, smem, stream>>>(dest, out, n, bins);
  }
  return static_cast<int>(cudaGetLastError());
}
