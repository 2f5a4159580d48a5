// Batched presence registers for Hopper (sm_90a).
//
// Replaces the TPU kernel presence_fill_pallas
// (thrill_tpu/core/pallas_kernels.py:239, kernel _presfill_kernel :218).
// out[r, m] = 1 iff some i has valid[r, i] != 0 and h[r, i] == m, for m
// in [0, regs); ids outside that range are ignored. These are the
// DuplicateDetection registers of ReduceByKey's destination program.
//
// Bound on this card: device memory. The kernel reads 5 bytes per row (an
// int32 register id and a bool) and writes regs bytes per row of the
// batch. The TPU kernel took an f32 one-hot max over (regs, 64) tiles
// across an in-order grid, O(regs * n) compares, hence its gate of 8192
// registers. Presence is idempotent, so here every lane of a valid row
// stores a 1 into the zeroed output: racing stores of the same value are
// benign and the result is exact, with any register count. At
// WordCount's size (2^17 registers) the stores spread over 128 KB.
//
// The caller zeroes `out`, allocates everything, and passes its stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void mark(uint8_t* o, int k, uint8_t ok,
                                     int regs) {
  if (ok && k >= 0 && k < regs) o[k] = 1;
}

// kVec: the row holds a multiple of 4 ids, so each lane loads 16 bytes of
// ids and 4 of flags at a time.
template <bool kVec>
__global__ void presfill_kernel(const int32_t* __restrict__ h,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ out, long long n,
                                int regs) {
  const int row = blockIdx.y;
  const int32_t* hr = h + static_cast<long long>(row) * n;
  const uint8_t* vr = valid + static_cast<long long>(row) * n;
  uint8_t* o = out + static_cast<long long>(row) * regs;

  const long long units = kVec ? n / 4 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < units; i += stride) {
    if (kVec) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(hr) + i);
      const uchar4 f = __ldg(reinterpret_cast<const uchar4*>(vr) + i);
      mark(o, k.x, f.x, regs);
      mark(o, k.y, f.y, regs);
      mark(o, k.z, f.z, regs);
      mark(o, k.w, f.w, regs);
    } else {
      mark(o, __ldg(hr + i), __ldg(vr + i), regs);
    }
  }
}

template <bool kVec>
void launch(const int32_t* h, const uint8_t* valid, uint8_t* out,
            long long n, int rows, int regs, int sms, cudaStream_t stream) {
  const long long units = kVec ? n / 4 : n;
  const long long want = (units + kThreads - 1) / kThreads;
  long long cap = (8LL * sms) / rows;
  if (cap < 1) cap = 1;
  const dim3 grid(static_cast<int>(want < cap ? want : cap), rows);
  presfill_kernel<kVec><<<grid, kThreads, 0, stream>>>(h, valid, out, n,
                                                       regs);
}

}  // namespace

extern "C" int thrill_presence_fill(const int32_t* h, const uint8_t* valid,
                                    uint8_t* out, long long n, int rows,
                                    int regs, int sms, cudaStream_t stream) {
  if (n > 0 && rows > 0 && regs > 0) {
    // rows start aligned when n % 4 == 0 (torch aligns the bases)
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(valid) % 4 == 0)
      launch<true>(h, valid, out, n, rows, regs, sms, stream);
    else
      launch<false>(h, valid, out, n, rows, regs, sms, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
