// Chunk-fed k-way merge over byte-encoded sort keys.
//
// The port's copy of the reference package's native/mwmerge.cpp. The
// host Sort (thrill_tpu_torch/api/ops/sort.py) spills sorted runs to
// block-store Files and merges them (Thrill: the partial multiway merge,
// thrill/api/sort.hpp:216-271, over core/multiway_merge.hpp:132). This
// engine does the comparison and selection:
//
// * Python feeds each run's key bytes in chunks (offsets and a blob, read
//   from the run's key File), so memory stays bounded by k chunks
//   whatever the runs' lengths; items never enter this engine.
// * mwm_next emits the merged order as run indices; the caller pulls each
//   emitted item from that run's item reader. It can also copy out the
//   winners' key bytes, for splitters and for intermediate merged runs
//   when the merge degree is capped.
// * Keys compare by memcmp (core/order_key.py makes that Python's
//   order), ties by run index, so the merge is stable in run order.
//
// A binary heap keyed by (key bytes, run) does the selection: about
// log2(64) = 6 memcmp levels an item at the default degree of 64.
//
// Build (thrill_tpu_torch/common/native_build.py load_host does it at
// first use): g++ -O3 -shared -fPIC -std=c++17 -pthread mwmerge.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Chunk {
  const int64_t* offs = nullptr;   // n + 1 exclusive offsets
  const uint8_t* blob = nullptr;
  int64_t n = 0;
  int64_t idx = 0;                 // next unconsumed key
  bool final_chunk = false;        // no refill will follow
};

struct Merger {
  explicit Merger(int32_t k) : runs(k), heap() { heap.reserve(k); }
  std::vector<Chunk> runs;
  std::vector<int32_t> heap;       // run indices, heap-ordered
  bool started = false;

  inline const uint8_t* key_ptr(int32_t r, int64_t* len) const {
    const Chunk& c = runs[r];
    *len = c.offs[c.idx + 1] - c.offs[c.idx];
    return c.blob + c.offs[c.idx];
  }

  // (key, run) strict-weak-order: memcmp lexicographic, run id tiebreak
  inline bool less(int32_t a, int32_t b) const {
    int64_t la, lb;
    const uint8_t* pa = key_ptr(a, &la);
    const uint8_t* pb = key_ptr(b, &lb);
    const int64_t m = la < lb ? la : lb;
    const int cmp = m ? std::memcmp(pa, pb, static_cast<size_t>(m)) : 0;
    if (cmp != 0) return cmp < 0;
    if (la != lb) return la < lb;
    return a < b;
  }

  void sift_up(size_t i) {
    while (i > 0) {
      size_t p = (i - 1) / 2;
      if (!less(heap[i], heap[p])) break;
      std::swap(heap[i], heap[p]);
      i = p;
    }
  }

  void sift_down(size_t i) {
    const size_t n = heap.size();
    for (;;) {
      size_t l = 2 * i + 1, r = l + 1, best = i;
      if (l < n && less(heap[l], heap[best])) best = l;
      if (r < n && less(heap[r], heap[best])) best = r;
      if (best == i) return;
      std::swap(heap[i], heap[best]);
      i = best;
    }
  }

  void push(int32_t r) {
    heap.push_back(r);
    sift_up(heap.size() - 1);
  }

  int32_t pop() {
    const int32_t top = heap[0];
    heap[0] = heap.back();
    heap.pop_back();
    if (!heap.empty()) sift_down(0);
    return top;
  }
};

}  // namespace

extern "C" {

void* mwm_create(int32_t k) {
  if (k <= 0) return nullptr;
  return new Merger(k);
}

void mwm_destroy(void* h) { delete static_cast<Merger*>(h); }

// 1 when every run is final and fully consumed (the merge emitted
// everything). Distinguishes "finished" from "out key-blob buffer too
// small for the next key" — both return early from mwm_next.
int32_t mwm_done(void* h) {
  Merger* m = static_cast<Merger*>(h);
  if (!m || !m->started || !m->heap.empty()) return 0;
  for (const Chunk& c : m->runs) {
    if (!c.final_chunk || c.idx != c.n) return 0;
  }
  return 1;
}

// Install run r's next chunk. Only legal before the first mwm_next or
// when mwm_next reported r via *need_refill (i.e. the previous chunk
// is fully consumed). The buffers must stay alive until the next
// set_chunk for r or mwm_destroy. Returns 0, or -1 on bad arguments.
int32_t mwm_set_chunk(void* h, int32_t r, int64_t n, const int64_t* offs,
                      const uint8_t* blob, int32_t final_chunk) {
  Merger* m = static_cast<Merger*>(h);
  if (!m || r < 0 || r >= static_cast<int32_t>(m->runs.size()) || n < 0) {
    return -1;
  }
  Chunk& c = m->runs[r];
  if (c.idx != c.n) return -1;       // previous chunk not consumed
  c.offs = offs;
  c.blob = blob;
  c.n = n;
  c.idx = 0;
  c.final_chunk = final_chunk != 0;
  if (m->started && n > 0) m->push(r);
  return 0;
}

// Emit up to out_cap merged run indices. If out_offs/out_blob are
// non-null, the winners' key bytes are appended there (out_offs gets
// count+1 exclusive offsets; emission stops early if blob_cap would
// overflow). On return *need_refill is the run whose chunk ran dry
// (its next key is unknown — the merge cannot proceed past it), or -1.
// The merge is COMPLETE when the returned count < out_cap and
// *need_refill == -1.
int64_t mwm_next(void* h, uint32_t* out_runs, int64_t out_cap,
                 int32_t* need_refill, int64_t* out_offs,
                 uint8_t* out_blob, int64_t blob_cap) {
  Merger* m = static_cast<Merger*>(h);
  *need_refill = -1;
  if (!m) return -1;
  if (!m->started) {
    m->started = true;
    // Re-entry after an aborted start would re-push runs already in
    // the heap and duplicate rows; start from an empty heap always.
    m->heap.clear();
    for (int32_t r = 0;
         r < static_cast<int32_t>(m->runs.size()); ++r) {
      Chunk& c = m->runs[r];
      if (c.n > 0) {
        m->push(r);
      } else if (!c.final_chunk) {
        *need_refill = r;            // caller must feed every run once
        m->started = false;
        return 0;
      }
    }
  }
  int64_t emitted = 0;
  int64_t blob_used = 0;
  if (out_offs) out_offs[0] = 0;
  while (emitted < out_cap && !m->heap.empty()) {
    const int32_t r = m->heap[0];
    if (out_blob) {
      int64_t klen;
      const uint8_t* kp = m->key_ptr(r, &klen);
      if (blob_used + klen > blob_cap) break;   // caller grows buffer
      std::memcpy(out_blob + blob_used, kp, static_cast<size_t>(klen));
      blob_used += klen;
      out_offs[emitted + 1] = blob_used;
    }
    m->pop();
    out_runs[emitted++] = static_cast<uint32_t>(r);
    Chunk& c = m->runs[r];
    ++c.idx;
    if (c.idx < c.n) {
      m->push(r);
    } else if (!c.final_chunk) {
      *need_refill = r;
      break;
    }
    // final + exhausted: run is done, nothing re-enters the heap
  }
  return emitted;
}
}  // extern "C"