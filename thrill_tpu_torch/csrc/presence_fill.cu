// Batched presence registers for Hopper (sm_90a).
//
// Replaces the TPU kernel presence_fill_pallas
// (thrill_tpu/core/pallas_kernels.py:239, kernel _presfill_kernel :218).
// out[r, m] = 1 iff some i has valid[r, i] != 0 and h[r, i] == m, for m
// in [0, regs); other ids are ignored, tested against [0, regs) at their
// full width (int32 or int64: no copy before the kernel). These are the
// DuplicateDetection registers of ReduceByKey's destination program.
//
// Bound on this card: device memory, counting what the inputs need:
// every flag byte, the id of each valid row, and the rows * regs
// registers written once. ReduceByKey hands over compacted shards (each
// worker's valid rows first), and at most 22 % of WordCount's rows are
// valid, so most of a row is flags only.
//
// Design. A warp takes 512 rows at a time: each lane loads 16 flags in
// one 16-byte load and stages them in shared memory. A chunk without a
// set flag ends there, so an invalid row costs its flag byte. Otherwise
// the warp loads the ids of the flagged rows coalesced (row 32 j + lane in
// step j), all 16 loads issued before any is used, and sets their bits in
// the block's shared bitset of the row's registers with atomicOr (16 KB
// for WordCount's 2^17). Each block then ORs its non-zero words into the
// row's global bitset (one atomicOr a word), and a second launch expands
// each bit to a u8 register with 16-byte stores and zeroes the global
// word again for the next launch on the stream: the output is written
// once and needs no zeroing launch. (Each block storing its bitset into
// a slice of scratch for the expand pass to OR was slower on WordCount's
// input, and so was a zeroing launch before the atomics: PERF.md.)
// The TPU kernel took an f32 one-hot max over (regs, 64) tiles, O(regs *
// n) compares, hence its gate of 8192 registers; the bitset's gate is
// kMaxBitsetRegs, the most a block's shared memory holds (ReduceByKey
// sizes at most 2^17 registers).
//
// The caller allocates everything and passes its stream: `bits` (rows *
// ceil(regs / 32) words) is zero before the launch and after it.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;                 // rows of a warp's step
constexpr int kPerLane = kChunk / 32;       // 16 flags: one 16-byte load
constexpr int kMaxBitsetRegs = 1 << 20;     // a 128 KB shared bitset

// Sets bit k of the shared bitset if k lies in [0, regs)
template <typename T>
__device__ __forceinline__ void mark(T k, int regs, uint32_t* set) {
  using U = typename std::make_unsigned<T>::type;
  const U u = static_cast<U>(k);
  if (u < static_cast<U>(regs)) atomicOr(&set[u >> 5], 1u << (u & 31));
}

// grid (blocks per row, rows): each block ORs its bitset into the row's
// words of bits ([rows, words])
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(const T* __restrict__ h, const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ bits, long long n, int regs,
                bool vec_flags) {
  extern __shared__ uint32_t set[];
  __shared__ uint4 staged[kWarps][32];
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = (regs + 31) / 32;
  for (int w = threadIdx.x; w < words; w += kThreads) set[w] = 0;
  __syncthreads();
  const T* hr = h + static_cast<long long>(row) * n;
  const uint8_t* vr = valid + static_cast<long long>(row) * n;
  uint8_t* sw = reinterpret_cast<uint8_t*>(staged[warp]);

  const long long chunks = (n + kChunk - 1) / kChunk;
  for (long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
       c < chunks; c += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = c * kChunk;
    unsigned any = 0;
    if (vec_flags && base + kChunk <= n) {
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(vr + base) + lane);
      staged[warp][lane] = f;
      any = f.x | f.y | f.z | f.w;
    } else {  // the ragged tail, or rows that do not start 16-byte aligned
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const long long i = base + 32 * j + lane;
        const uint8_t f = i < n ? __ldg(vr + i) : 0;
        sw[32 * j + lane] = f;
        any |= f;
      }
    }
    if (!__any_sync(0xffffffffu, any != 0)) continue;
    __syncwarp();
    T k[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      k[j] = sw[32 * j + lane] ? __ldg(hr + base + 32 * j + lane) : T(-1);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) mark(k[j], regs, set);
    __syncwarp();  // the next chunk restages sw
  }

  __syncthreads();
  uint32_t* dst = bits + static_cast<long long>(row) * words;
  for (int w = threadIdx.x; w < words; w += kThreads)
    if (set[w]) atomicOr(&dst[w], set[w]);
}

// Four register bytes (0 or 1) from the low four bits of x
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

// grid (ceil(words / 256), rows): a thread per bitset word writes the
// word's 32 registers and zeroes the word
__global__ void __launch_bounds__(256)
    expand_kernel(uint32_t* __restrict__ bits, uint8_t* __restrict__ out,
                  int words, int regs, bool vec_out) {
  const int row = blockIdx.y;
  const int w = blockIdx.x * 256 + threadIdx.x;
  if (w >= words) return;
  uint32_t* bw = bits + static_cast<long long>(row) * words + w;
  const uint32_t m = __ldcg(bw);
  *bw = 0;
  uint8_t* o = out + static_cast<long long>(row) * regs + 32LL * w;
  if (vec_out && 32 * w + 32 <= regs) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    o4[0] = make_uint4(spread4(m), spread4(m >> 4), spread4(m >> 8),
                       spread4(m >> 12));
    o4[1] = make_uint4(spread4(m >> 16), spread4(m >> 20), spread4(m >> 24),
                       spread4(m >> 28));
  } else {
    for (int j = 0; j < 32 && 32 * w + j < regs; ++j) o[j] = (m >> j) & 1u;
  }
}

template <typename T>
int launch(const T* h, const uint8_t* valid, uint32_t* bits, uint8_t* out,
           long long n, int rows, int regs, int blocks_per_row,
           cudaStream_t stream) {
  const dim3 grid(blocks_per_row, rows);
  // rows start 16-byte aligned when n % 16 == 0 (torch aligns the base)
  const bool vec_flags = n % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(valid) % 16 == 0;
  const int words = (regs + 31) / 32;
  const int smem = words * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&fill_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_kernel<T><<<grid, kThreads, smem, stream>>>(h, valid, bits, n, regs,
                                                   vec_flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_out = regs % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  expand_kernel<<<dim3((words + 255) / 256, rows), 256, 0, stream>>>(
      bits, out, words, regs, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: [rows, n] ids of id_bytes (4: int32, 8: int64); valid: [rows, n]
// bytes; bits: rows * ceil(regs / 32) zero words, left zero; regs <=
// kMaxBitsetRegs. out needs no zeroing.
extern "C" int thrill_presence_fill(const void* h, int id_bytes,
                                    const uint8_t* valid, uint32_t* bits,
                                    uint8_t* out, long long n, int rows,
                                    int regs, int blocks_per_row,
                                    cudaStream_t stream) {
  if (regs > kMaxBitsetRegs) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || regs <= 0) return static_cast<int>(cudaGetLastError());
  if (id_bytes == 8)
    return launch(static_cast<const long long*>(h), valid, bits, out, n,
                  rows, regs, blocks_per_row, stream);
  return launch(static_cast<const int32_t*>(h), valid, bits, out, n, rows,
                regs, blocks_per_row, stream);
}
