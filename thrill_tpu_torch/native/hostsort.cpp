// Host-side sort and grouping engines for a CPU mesh.
//
// The port's copy of the reference package's native/hostsort.cpp, with
// the same entry points and the same outputs bit for bit. The reference
// framework's local-sort phase runs a tuned host sort (sort_algorithm_ =
// std::sort / tlx radix variants, selected per key type). On a mesh whose
// device is the CPU the shards are host memory, so the same engine choice
// applies: a stable LSD radix argsort over the encoded lexicographic
// uint64 key words, plus a row gather for the single payload permutation,
// and a hash-grouping table for ReduceByKey, ReduceToIndex and
// GroupByKey. On the card the device engines (thrill_tpu_torch/core/
// device_sort.py, the csrc/ kernels) run instead; this file is never used
// there.
//
// Layout notes:
// * 16-bit digits: 65536-entry u32 histogram (256 KiB) per pass.
// * Uniform-digit passes are detected from the histogram and skipped
//   (zero-padded packed byte keys make most high/low passes uniform).
// * Stability comes from the counting scatter being order-preserving;
//   the caller needs no tie-break iota word.
//
// Build (thrill_tpu_torch/common/native_build.py load_host does it at
// first use): g++ -O3 -shared -fPIC -std=c++17 -pthread hostsort.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kDigitBits = 16;
constexpr uint32_t kBuckets = 1u << kDigitBits;
constexpr uint64_t kDigitMask = kBuckets - 1;

}  // namespace

extern "C" {

// Stable argsort of n items keyed lexicographically by nwords uint64
// words (words[w][i]; w = 0 is the MOST significant word). On return
// perm_out[r] = original index of the r-th smallest item. Returns the
// number of counting passes actually performed (>= 0), or -1 on bad
// arguments.
int radix_argsort_u64(int64_t n, int32_t nwords, const uint64_t** words,
                      uint32_t* perm_out) {
  if (n < 0 || nwords <= 0 || n > static_cast<int64_t>(UINT32_MAX)) {
    return -1;
  }
  std::vector<uint32_t> tmp(static_cast<size_t>(n));
  std::vector<uint32_t> hist(kBuckets);
  uint32_t* cur = perm_out;
  uint32_t* alt = tmp.data();
  for (int64_t i = 0; i < n; ++i) cur[i] = static_cast<uint32_t>(i);

  int passes = 0;
  // least-significant word first, least-significant digit first
  for (int w = nwords - 1; w >= 0; --w) {
    const uint64_t* col = words[w];
    for (int shift = 0; shift < 64; shift += kDigitBits) {
      std::memset(hist.data(), 0, kBuckets * sizeof(uint32_t));
      for (int64_t i = 0; i < n; ++i) {
        ++hist[(col[cur[i]] >> shift) & kDigitMask];
      }
      // skip uniform passes (common: zero-padded key bytes)
      if (n > 0 && hist[(col[cur[0]] >> shift) & kDigitMask] ==
                       static_cast<uint32_t>(n)) {
        continue;
      }
      uint32_t sum = 0;
      for (uint32_t b = 0; b < kBuckets; ++b) {
        uint32_t c = hist[b];
        hist[b] = sum;
        sum += c;
      }
      for (int64_t i = 0; i < n; ++i) {
        uint32_t idx = cur[i];
        alt[hist[(col[idx] >> shift) & kDigitMask]++] = idx;
      }
      std::swap(cur, alt);
      ++passes;
    }
  }
  if (cur != perm_out) {
    std::memcpy(perm_out, cur, static_cast<size_t>(n) * sizeof(uint32_t));
  }
  return passes;
}

// dst row r = src row perm[r]; rows are row_bytes wide. Fixed-size
// cases use memcpy loads/stores (compilers emit the single mov either
// way) so contiguous-but-misaligned buffers are not UB.
void gather_rows_u8(int64_t n, int64_t row_bytes, const uint8_t* src,
                    const uint32_t* perm, uint8_t* dst) {
  switch (row_bytes) {
    case 1: {
      for (int64_t r = 0; r < n; ++r) dst[r] = src[perm[r]];
      return;
    }
    case 2: {
      for (int64_t r = 0; r < n; ++r) {
        uint16_t v;
        std::memcpy(&v, src + static_cast<int64_t>(perm[r]) * 2, 2);
        std::memcpy(dst + r * 2, &v, 2);
      }
      return;
    }
    case 4: {
      for (int64_t r = 0; r < n; ++r) {
        uint32_t v;
        std::memcpy(&v, src + static_cast<int64_t>(perm[r]) * 4, 4);
        std::memcpy(dst + r * 4, &v, 4);
      }
      return;
    }
    case 8: {
      for (int64_t r = 0; r < n; ++r) {
        uint64_t v;
        std::memcpy(&v, src + static_cast<int64_t>(perm[r]) * 8, 8);
        std::memcpy(dst + r * 8, &v, 8);
      }
      return;
    }
    default: {
      for (int64_t r = 0; r < n; ++r) {
        std::memcpy(dst + r * row_bytes,
                    src + static_cast<int64_t>(perm[r]) * row_bytes,
                    static_cast<size_t>(row_bytes));
      }
    }
  }
}

// dst row idx[r] = src row r (inverse of gather_rows_u8). Same memcpy
// discipline for the fixed-size fast paths.
void scatter_rows_u8(int64_t n, int64_t row_bytes, const uint8_t* src,
                     const uint32_t* idx, uint8_t* dst) {
  switch (row_bytes) {
    case 1: {
      for (int64_t r = 0; r < n; ++r) dst[idx[r]] = src[r];
      return;
    }
    case 2: {
      for (int64_t r = 0; r < n; ++r) {
        uint16_t v;
        std::memcpy(&v, src + r * 2, 2);
        std::memcpy(dst + static_cast<int64_t>(idx[r]) * 2, &v, 2);
      }
      return;
    }
    case 4: {
      for (int64_t r = 0; r < n; ++r) {
        uint32_t v;
        std::memcpy(&v, src + r * 4, 4);
        std::memcpy(dst + static_cast<int64_t>(idx[r]) * 4, &v, 4);
      }
      return;
    }
    case 8: {
      for (int64_t r = 0; r < n; ++r) {
        uint64_t v;
        std::memcpy(&v, src + r * 8, 8);
        std::memcpy(dst + static_cast<int64_t>(idx[r]) * 8, &v, 8);
      }
      return;
    }
    default: {
      for (int64_t r = 0; r < n; ++r) {
        std::memcpy(dst + static_cast<int64_t>(idx[r]) * row_bytes,
                    src + r * row_bytes,
                    static_cast<size_t>(row_bytes));
      }
    }
  }
}

namespace {

// splitmix64 finalizer: the per-word mixer for the grouping table.
inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Open-addressing (linear probe) find-or-insert keyed by exact
// equality of nwords uint64 key words, shared by hash_group_u64 and
// hash_group_acc_u64 so the probing scheme cannot diverge between the
// grouped and fused engines. Sized once for a known max row count
// (load factor <= 0.5, so the linear probe terminates).
struct GroupTable {
  std::vector<uint32_t> head_plus1;  // original row index + 1; 0 empty
  std::vector<uint32_t> slot_gid;
  const uint64_t** words;
  int32_t nwords;
  size_t mask;
  uint32_t ngroups = 0;

  GroupTable(int64_t n, int32_t nw, const uint64_t** w)
      : words(w), nwords(nw) {
    size_t tsize = 16;
    while (tsize < static_cast<size_t>(n) * 2) tsize <<= 1;
    mask = tsize - 1;
    head_plus1.assign(tsize, 0);
    slot_gid.resize(tsize);
  }

  // Returns the row's group id; *is_new reports whether row i opened
  // the group (i becomes its head row).
  inline uint32_t find_or_insert(int64_t i, bool* is_new) {
    uint64_t h = 0;
    for (int32_t w = 0; w < nwords; ++w) h = mix64(h ^ words[w][i]);
    size_t s = static_cast<size_t>(h) & mask;
    for (;;) {
      const uint32_t hp = head_plus1[s];
      if (hp == 0) {
        head_plus1[s] = static_cast<uint32_t>(i) + 1;
        slot_gid[s] = ngroups;
        *is_new = true;
        return ngroups++;
      }
      const uint32_t head = hp - 1;
      bool eq = true;
      for (int32_t w = 0; w < nwords; ++w) {
        if (words[w][head] != words[w][i]) {
          eq = false;
          break;
        }
      }
      if (eq) {
        *is_new = false;
        return slot_gid[s];
      }
      s = (s + 1) & mask;
    }
  }
};

}  // namespace

// Group n rows by EXACT equality of their nwords uint64 key words via
// an open-addressing (linear probe) hash table with full-key compare —
// the host-native analog of the reference's ReducePrePhase probing
// tables (thrill/core/reduce_pre_phase.hpp:94). Collisions are
// resolved by comparing every key word, so the grouping is exact for
// any key distribution.
//
// Outputs:
//   perm_out[n]   — row indices clustered group-by-group (groups in
//                   first-appearance order; original order kept WITHIN
//                   a group, so non-commutative folds stay correct)
//   lens_out[<=n] — rows per group
// Returns the number of groups, or -1 on bad arguments.
//
// Cost model vs the radix argsort above: one pass with ~1 probe per
// row. Live table entries (one per DISTINCT key) cluster in cache, so
// skewed key sets (the WordCount case) probe mostly L1/L2 instead of
// paying 4+ full counting passes.
int64_t hash_group_u64(int64_t n, int32_t nwords, const uint64_t** words,
                       uint32_t* perm_out, uint32_t* lens_out) {
  if (n < 0 || nwords <= 0 || n > static_cast<int64_t>(UINT32_MAX)) {
    return -1;
  }
  if (n == 0) return 0;
  GroupTable table(n, nwords, words);
  std::vector<uint32_t> gids(static_cast<size_t>(n));
  std::vector<uint32_t> counts;
  counts.reserve(1024);
  for (int64_t i = 0; i < n; ++i) {
    bool is_new;
    const uint32_t g = table.find_or_insert(i, &is_new);
    gids[i] = g;
    if (is_new) {
      counts.push_back(1);
    } else {
      ++counts[g];
    }
  }
  const int64_t ngroups = static_cast<int64_t>(counts.size());
  std::vector<uint32_t> off(counts.size());
  uint32_t sum = 0;
  for (int64_t g = 0; g < ngroups; ++g) {
    off[g] = sum;
    sum += counts[g];
    lens_out[g] = counts[g];
  }
  for (int64_t i = 0; i < n; ++i) {
    perm_out[off[gids[i]]++] = static_cast<uint32_t>(i);
  }
  return ngroups;
}

// Fused variant of hash_group_u64 for DECLARATIVE reduce functors
// (api/functors.py FieldReduce): the value columns are accumulated
// into the table during the single probe pass, which is the runtime
// analog of the reference's C++ templates inlining the reduce functor
// into the probing-table insert (thrill/core/reduce_pre_phase.hpp:94,
// reduce_functional.hpp). No permutation, gather, or fold pass exists
// afterwards — the output is one row per group.
//
// col_ops[c] selects the accumulator for value column c (all columns
// are 8-byte scalars, pre-converted by the caller):
//   0 sum_i64 (two's-complement: also exact mod-2^64 for uint64)
//   1 min_i64   2 max_i64
//   3 sum_f64   4 min_f64 (NaN propagates, numpy-parity)
//   5 max_f64 (NaN propagates)
//   6 min_u64   7 max_u64
// acc_out[c] (capacity n rows) receives ngroups accumulated values;
// heads_out[g] = original row index of group g's FIRST row (for
// "first" columns the caller gathers those rows). Returns ngroups or
// -1 on bad arguments.
int64_t hash_group_acc_u64(int64_t n, int32_t nwords,
                           const uint64_t** words, int32_t ncols,
                           const int32_t* col_ops, const void** cols,
                           void** acc_out, uint32_t* heads_out) {
  if (n < 0 || nwords <= 0 || ncols < 0 ||
      n > static_cast<int64_t>(UINT32_MAX)) {
    return -1;
  }
  for (int32_t c = 0; c < ncols; ++c) {
    if (col_ops[c] < 0 || col_ops[c] > 7) return -1;
  }
  if (n == 0) return 0;
  GroupTable table(n, nwords, words);
  for (int64_t i = 0; i < n; ++i) {
    bool is_new;
    const int64_t g = table.find_or_insert(i, &is_new);
    if (is_new) {
      heads_out[g] = static_cast<uint32_t>(i);
      for (int32_t c = 0; c < ncols; ++c) {
        std::memcpy(static_cast<uint8_t*>(acc_out[c]) + g * 8,
                    static_cast<const uint8_t*>(cols[c]) + i * 8, 8);
      }
      continue;
    }
    for (int32_t c = 0; c < ncols; ++c) {
      uint8_t* ap = static_cast<uint8_t*>(acc_out[c]) + g * 8;
      const uint8_t* vp = static_cast<const uint8_t*>(cols[c]) + i * 8;
      switch (col_ops[c]) {
        case 0: {  // sum_i64
          int64_t a, v;
          std::memcpy(&a, ap, 8);
          std::memcpy(&v, vp, 8);
          a = static_cast<int64_t>(static_cast<uint64_t>(a) +
                                   static_cast<uint64_t>(v));
          std::memcpy(ap, &a, 8);
          break;
        }
        case 1: case 2: {  // min_i64 / max_i64
          int64_t a, v;
          std::memcpy(&a, ap, 8);
          std::memcpy(&v, vp, 8);
          if (col_ops[c] == 1 ? (v < a) : (v > a)) std::memcpy(ap, &v, 8);
          break;
        }
        case 3: {  // sum_f64
          double a, v;
          std::memcpy(&a, ap, 8);
          std::memcpy(&v, vp, 8);
          a += v;
          std::memcpy(ap, &a, 8);
          break;
        }
        case 4: case 5: {  // min_f64 / max_f64, NaN propagates
          double a, v;
          std::memcpy(&a, ap, 8);
          std::memcpy(&v, vp, 8);
          if (a != a) break;           // acc already NaN
          if (v != v || (col_ops[c] == 4 ? (v < a) : (v > a))) {
            std::memcpy(ap, &v, 8);
          }
          break;
        }
        case 6: case 7: {  // min_u64 / max_u64
          uint64_t a, v;
          std::memcpy(&a, ap, 8);
          std::memcpy(&v, vp, 8);
          if (col_ops[c] == 6 ? (v < a) : (v > a)) std::memcpy(ap, &v, 8);
          break;
        }
      }
    }
  }
  return static_cast<int64_t>(table.ngroups);
}

// Plan for the strided in-place run fold over group-contiguous rows
// (see api/ops/reduce.py _strided_run_fold). Row at in-run
// position p > 0 is absorbed exactly once, at step s = p & -p, into
// the row s slots to its left; this emits the absorbed (right-operand)
// GLOBAL row indices bucketed by level l = ctz(p), ascending within a
// level. level_counts_out must hold 32 slots. Returns the total number
// of emitted indices (== sum(lens) - ngroups).
int64_t fold_plan_u32(int64_t ngroups, const uint32_t* lens,
                      uint32_t* ri_out, int64_t* level_counts_out) {
  for (int l = 0; l < 32; ++l) level_counts_out[l] = 0;
  for (int64_t g = 0; g < ngroups; ++g) {
    for (uint32_t p = 1; p < lens[g]; ++p) {
      ++level_counts_out[__builtin_ctz(p)];
    }
  }
  int64_t off[32];
  int64_t sum = 0;
  for (int l = 0; l < 32; ++l) {
    off[l] = sum;
    sum += level_counts_out[l];
  }
  uint32_t start = 0;
  for (int64_t g = 0; g < ngroups; ++g) {
    const uint32_t len = lens[g];
    for (uint32_t p = 1; p < len; ++p) {
      ri_out[off[__builtin_ctz(p)]++] = start + p;
    }
    start += len;
  }
  return sum;
}
}  // extern "C"
