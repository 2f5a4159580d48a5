// Columnar spill records: the encode engine of the host Sort's spill,
// run outside the GIL.
//
// The port's copy of the reference package's native/records.cpp. The
// Sort's write-behind job (thrill_tpu_torch/api/ops/sort.py) sorts and
// encodes each spilled run here, through two entry points that ctypes
// calls with the GIL released, so the writer thread runs beside the main
// thread's next run:
//
// * rec_argsort: lexicographic (memcmp) argsort of n rows of w bytes.
//   Rows carry a big-endian position suffix (core/order_key.py), so
//   they are unique and any comparison sort gives the one total order;
//   memcmp order is numpy's S-dtype order (the \0 pad is the least
//   byte), so this and the numpy fallback agree row for row.
// * rec_gather: gather rows [i0, i1) of a permutation from ncols
//   fixed-width columns into one column-major buffer: the payload of one
//   spill block, written straight behind the block header that the
//   caller already put there (data/serializer.py, the columnar kind).
//
// Python (data/records.py) owns schemas, headers and block slicing; this
// file owns only bytes.
//
// Build (thrill_tpu_torch/common/native_build.py load_host does it at
// first use): g++ -O3 -shared -fPIC -std=c++17 -pthread records.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>

extern "C" {

// Lexicographic argsort of n rows of w bytes each (memcmp order, row
// index tiebreak). out must hold n int64 slots. Returns 0, -1 on bad
// arguments.
int32_t rec_argsort(const uint8_t* rows, int64_t w, int64_t n,
                    int64_t* out) {
  if (!rows || !out || w <= 0 || n < 0) return -1;
  std::iota(out, out + n, static_cast<int64_t>(0));
  const size_t width = static_cast<size_t>(w);
  std::sort(out, out + n, [rows, width](int64_t a, int64_t b) {
    const int c = std::memcmp(rows + static_cast<size_t>(a) * width,
                              rows + static_cast<size_t>(b) * width,
                              width);
    if (c != 0) return c < 0;
    return a < b;  // rows are unique (pos suffix); keep it total anyway
  });
  return 0;
}

// Gather rows order[i0:i1] from ncols columns (widths[c] bytes per
// row, each column C-contiguous) into out, column-major: col 0's
// gathered rows, then col 1's, ... Returns total bytes written, or -1
// on bad arguments. The caller guarantees order values index every
// column validly.
int64_t rec_gather(int32_t ncols, const uint8_t* const* cols,
                   const int64_t* widths, const int64_t* order,
                   int64_t i0, int64_t i1, uint8_t* out) {
  if (ncols < 0 || !out || i0 < 0 || i1 < i0 ||
      (ncols > 0 && (!cols || !widths || !order))) {
    return -1;
  }
  uint8_t* dst = out;
  for (int32_t c = 0; c < ncols; ++c) {
    const uint8_t* src = cols[c];
    const size_t w = static_cast<size_t>(widths[c]);
    if (!src || widths[c] <= 0) return -1;
    switch (w) {
      case 8:  // the dominant case: int64/float64 scalar columns
        for (int64_t j = i0; j < i1; ++j) {
          std::memcpy(dst, src + static_cast<size_t>(order[j]) * 8, 8);
          dst += 8;
        }
        break;
      default:
        for (int64_t j = i0; j < i1; ++j) {
          std::memcpy(dst, src + static_cast<size_t>(order[j]) * w, w);
          dst += w;
        }
    }
  }
  return static_cast<int64_t>(dst - out);
}

}  // extern "C"
