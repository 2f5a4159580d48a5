// Native host-side block store with LRU spill-to-disk.
//
// Equivalent of the reference's data-plane core: ByteBlock/Block
// ref-counted buffers (reference: thrill/data/byte_block.hpp:51,
// block.hpp:52) managed by a BlockPool with soft/hard RAM limits and
// LRU eviction to disk (reference: thrill/data/block_pool.hpp:42, which
// spills through foxxll async I/O). Here the store backs the Python
// data layer through a ctypes interface: Python owns scheduling, C++
// owns bytes — copies, pinning, spill files, and newline scanning for
// the ReadLines byte-range splitter (reference: api/read_lines.hpp:181).
//
// Spills are ASYNCHRONOUS by default: eviction moves the bytes into an
// immutable write request processed by a dedicated writer thread (the
// analog of foxxll's async disk queue / the reference's Dispatcher
// thread, net/dispatcher.hpp:510) — Put/Unpin never block on disk.
// Pin/Get of an in-flight block are served from the request buffer;
// pinning cancels the spill (the writer removes the file post-write).
//
// The port's copy of the reference package's native/blockstore.cpp, less
// its line scanner (bs_scan_lines, which nothing of the port calls), plus
// one counter: the bytes written to spill files (bs_spilled_bytes), and
// one change to how a block's bytes are copied. A block of 2 MiB or more
// is mapped with its pages populated in one call (MAP_POPULATE) instead
// of one page fault each 4 KiB as the copy first touches them, a smaller
// one is malloc'ed without a zeroing pass, and Put fills it outside the
// store's lock; Put and Get copy a block of 16 MiB or more with several
// threads. The one copy of a Put into fresh pages was the spill's rate
// (2.0-2.7 GB/s on an H100 host).
//
// Build (thrill_tpu_torch/common/native_build.py does it at first use):
// g++ -O3 -shared -fPIC -std=c++17 -pthread blockstore.cpp -o libblockstore.so

#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cctype>
#include <cstring>
#include <deque>
#include <list>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kMapFrom = size_t(2) << 20;   // mapped from here up
constexpr int64_t kParallelCopy = int64_t(16) << 20;

// Block memory: uninitialised on resize; a large block mapped with its
// pages populated.
template <typename T>
struct BlockAlloc {
  using value_type = T;
  BlockAlloc() = default;
  template <typename U>
  BlockAlloc(const BlockAlloc<U>&) {}
  T* allocate(size_t n) {
    const size_t bytes = n * sizeof(T);
    if (bytes < kMapFrom) {
      void* p = std::malloc(bytes ? bytes : 1);
      if (!p) throw std::bad_alloc();
      return static_cast<T*>(p);
    }
    void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
    if (p == MAP_FAILED) throw std::bad_alloc();
    return static_cast<T*>(p);
  }
  void deallocate(T* p, size_t n) {
    if (n * sizeof(T) < kMapFrom) {
      std::free(p);
    } else {
      munmap(p, n * sizeof(T));
    }
  }
  template <typename U>
  void construct(U* p) noexcept {
    ::new (static_cast<void*>(p)) U;       // default-init: no zeroing
  }
  template <typename U, typename... A>
  void construct(U* p, A&&... a) {
    ::new (static_cast<void*>(p)) U(std::forward<A>(a)...);
  }
  template <typename U>
  bool operator==(const BlockAlloc<U>&) const { return true; }
  template <typename U>
  bool operator!=(const BlockAlloc<U>&) const { return false; }
};

using Bytes = std::vector<char, BlockAlloc<char>>;

// memcpy of a large block by several threads: the page faults of fresh
// destination pages (and the copy) spread over the host's cores.
void CopyBytes(void* dst, const void* src, int64_t n) {
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t parts =
      n < kParallelCopy ? 1 : std::min<int64_t>(hw ? hw : 1, 8);
  if (parts <= 1) {
    std::memcpy(dst, src, static_cast<size_t>(n));
    return;
  }
  const int64_t step = (n / parts + 4095) / 4096 * 4096;
  std::vector<std::thread> pool;
  for (int64_t lo = step; lo < n; lo += step) {
    const int64_t len = std::min(step, n - lo);
    pool.emplace_back([=] {
      std::memcpy(static_cast<char*>(dst) + lo,
                  static_cast<const char*>(src) + lo,
                  static_cast<size_t>(len));
    });
  }
  std::memcpy(dst, src, static_cast<size_t>(std::min(step, n)));
  for (auto& t : pool) t.join();
}

struct SpillRequest {
  int64_t id = 0;
  Bytes data;                   // owned; IMMUTABLE once enqueued
  std::string path;
  bool cancelled = false;       // guarded by the store mutex
};

struct Block {
  Bytes data;                   // empty when spilled or spilling
  std::string spill_path;       // non-empty when on disk
  std::shared_ptr<SpillRequest> req;  // non-null while write in flight
  int64_t size = 0;
  int64_t pin_count = 0;
  std::list<int64_t>::iterator lru_it;
  bool in_lru = false;
};

class BlockStore {
 public:
  BlockStore(std::string spill_dir, int64_t soft_limit, bool async_io)
      : spill_dir_(std::move(spill_dir)), soft_limit_(soft_limit),
        async_(async_io) {
    if (async_) writer_ = std::thread([this] { WriterLoop(); });
  }

  ~BlockStore() {
    if (async_) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        stop_ = true;
      }
      cv_work_.notify_all();
      writer_.join();
    }
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : blocks_) {
      if (!kv.second.spill_path.empty())
        std::remove(kv.second.spill_path.c_str());
    }
  }

  int64_t Put(const void* data, int64_t size) {
    // the one copy, into the block's own memory, outside the lock
    Bytes bytes(static_cast<size_t>(size));
    if (size > 0) CopyBytes(bytes.data(), data, size);
    std::lock_guard<std::mutex> lk(mu_);
    int64_t id = next_id_++;
    Block& b = blocks_[id];
    b.size = size;
    b.data = std::move(bytes);
    mem_usage_ += size;
    Touch(id, b);
    MaybeSpill();
    return id;
  }

  int64_t Size(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    return it == blocks_.end() ? -1 : it->second.size;
  }

  // Copy block contents into out (caller allocates Size(id) bytes).
  // Returns 0 on success, -1 unknown id, -2 I/O error.
  int Get(int64_t id, void* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    if (it == blocks_.end()) return -1;
    Block& b = it->second;
    if (!b.data.empty() || b.size == 0) {
      CopyBytes(out, b.data.data(), b.size);
      Touch(id, b);
      return 0;
    }
    if (b.req) {  // write in flight: serve from the request buffer
      CopyBytes(out, b.req->data.data(), b.size);
      return 0;
    }
    // fault in from disk (stays spilled; read-through)
    FILE* f = std::fopen(b.spill_path.c_str(), "rb");
    if (!f) return -2;
    size_t got = std::fread(out, 1, b.size, f);
    std::fclose(f);
    return got == static_cast<size_t>(b.size) ? 0 : -2;
  }

  // Bring a spilled block back to RAM and keep it there while pinned.
  int Pin(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    if (it == blocks_.end()) return -1;
    Block& b = it->second;
    if (b.data.empty() && b.size > 0 && b.req) {
      // cancel the in-flight spill: copy back (the writer may be
      // mid-fwrite from the request buffer, so it cannot be moved)
      b.data = b.req->data;
      b.req->cancelled = true;
      b.req.reset();
      mem_usage_ += b.size;
    } else if (b.data.empty() && b.size > 0) {
      FILE* f = std::fopen(b.spill_path.c_str(), "rb");
      if (!f) return -2;
      b.data.resize(b.size);
      size_t got = std::fread(b.data.data(), 1, b.size, f);
      std::fclose(f);
      if (got != static_cast<size_t>(b.size)) return -2;
      std::remove(b.spill_path.c_str());
      b.spill_path.clear();
      mem_usage_ += b.size;
    }
    b.pin_count++;
    if (b.in_lru) {
      lru_.erase(b.lru_it);
      b.in_lru = false;
    }
    return 0;
  }

  int Unpin(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    if (it == blocks_.end()) return -1;
    Block& b = it->second;
    if (b.pin_count > 0) b.pin_count--;
    if (b.pin_count == 0 && !b.data.empty()) Touch(id, b);
    MaybeSpill();
    return 0;
  }

  void Drop(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    if (it == blocks_.end()) return;
    Block& b = it->second;
    if (!b.data.empty()) mem_usage_ -= b.size;
    if (b.in_lru) lru_.erase(b.lru_it);
    if (b.req) b.req->cancelled = true;  // writer removes its file
    if (!b.spill_path.empty()) std::remove(b.spill_path.c_str());
    blocks_.erase(it);
  }

  // Is the block servable from RAM (resident, or its spill write is
  // still in flight with the request buffer alive)? 1 = RAM, 0 = a
  // Get would fault in from disk, -1 = unknown id. Drives the
  // surgical merge readahead (data/file.py prefetch_reader): only
  // disk-resident blocks are worth a background fetch.
  int Resident(int64_t id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = blocks_.find(id);
    if (it == blocks_.end()) return -1;
    Block& b = it->second;
    return (!b.data.empty() || b.size == 0 || b.req) ? 1 : 0;
  }

  int64_t MemUsage() {
    std::lock_guard<std::mutex> lk(mu_);
    return mem_usage_;
  }

  int64_t SpilledBytes() {
    std::lock_guard<std::mutex> lk(mu_);
    return spilled_bytes_;
  }

  int64_t NumBlocks() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int64_t>(blocks_.size());
  }

  // Block until every queued/in-flight spill write has completed.
  void Flush() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_idle_.wait(lk, [this] { return queue_.empty() && inflight_ == 0; });
  }

  int64_t Pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int64_t>(queue_.size()) + inflight_;
  }

 private:
  void WriterLoop() {
    for (;;) {
      std::shared_ptr<SpillRequest> req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) return;  // stop_ and drained
        req = queue_.front();
        queue_.pop_front();
        if (req->cancelled) {        // Pin/Drop got there first:
          spilling_bytes_ -= static_cast<int64_t>(req->data.size());
          cv_idle_.notify_all();     // skip the disk write entirely
          continue;
        }
        inflight_++;
      }
      // file write OUTSIDE the lock: the request buffer is immutable
      bool ok = false;
      FILE* f = std::fopen(req->path.c_str(), "wb");
      if (f) {
        size_t put = std::fwrite(req->data.data(), 1, req->data.size(), f);
        std::fclose(f);
        ok = put == req->data.size();
        if (!ok) std::remove(req->path.c_str());
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        inflight_--;
        spilling_bytes_ -= static_cast<int64_t>(req->data.size());
        auto it = blocks_.find(req->id);
        if (req->cancelled || it == blocks_.end()) {
          if (ok) std::remove(req->path.c_str());
        } else if (ok) {
          spilled_bytes_ += static_cast<int64_t>(req->data.size());
          it->second.spill_path = req->path;
          it->second.req.reset();
        } else {
          // write failed: restore the bytes to RAM (cannot move — the
          // request may still be aliased; copy like Pin does)
          Block& b = it->second;
          b.data = req->data;
          b.req.reset();
          mem_usage_ += b.size;
          Touch(req->id, b);
        }
        cv_idle_.notify_all();
      }
    }
  }
  void Touch(int64_t id, Block& b) {
    if (b.in_lru) lru_.erase(b.lru_it);
    lru_.push_front(id);
    b.lru_it = lru_.begin();
    b.in_lru = true;
  }

  std::string SpillPath(int64_t victim) {
    // the owning host+pid ride in the name so an external sweeper
    // (data/block_pool.py purge_stale_spills) can reclaim files whose
    // process died without running the destructor (kill -9, abort) —
    // and, on a spill dir shared across hosts, never judge a REMOTE
    // process's file by local pid liveness. Hostname sanitized to
    // [A-Za-z0-9_] so the dash-delimited name stays parseable.
    static const std::string host = [] {
      char h[128] = "unknown";
      gethostname(h, sizeof(h) - 1);
      std::string s(h);
      for (char& c : s)
        if (!std::isalnum(static_cast<unsigned char>(c))) c = '_';
      return s.empty() ? std::string("unknown") : s;
    }();
    char path[512];
    std::snprintf(path, sizeof(path),
                  "%s/ttpu-blk-%lld-%p-%lld-%s.spill",
                  spill_dir_.c_str(),
                  static_cast<long long>(getpid()),
                  static_cast<void*>(this),
                  static_cast<long long>(victim), host.c_str());
    return path;
  }

  void MaybeSpill() {
    bool queued = false;
    while (soft_limit_ > 0 && mem_usage_ > soft_limit_ && !lru_.empty()) {
      int64_t victim = lru_.back();
      lru_.pop_back();
      Block& b = blocks_[victim];
      b.in_lru = false;
      if (b.data.empty() || b.pin_count > 0) continue;
      // bounded write pool (foxxll semantics): async only while the
      // in-flight bytes stay under the budget; past it, spill
      // synchronously — Put/Unpin then block on disk, which is the
      // backpressure that keeps real RSS bounded at ~2x soft_limit
      if (async_ && spilling_bytes_ < soft_limit_) {
        auto req = std::make_shared<SpillRequest>();
        req->id = victim;
        req->data = std::move(b.data);
        req->path = SpillPath(victim);
        b.data.clear();
        b.data.shrink_to_fit();
        b.req = req;
        mem_usage_ -= b.size;
        spilling_bytes_ += b.size;
        queue_.push_back(std::move(req));
        queued = true;
        continue;
      }
      std::string path = SpillPath(victim);
      FILE* f = std::fopen(path.c_str(), "wb");
      if (!f) return;  // cannot spill; keep in RAM
      size_t put = std::fwrite(b.data.data(), 1, b.size, f);
      std::fclose(f);
      if (put != static_cast<size_t>(b.size)) {
        std::remove(path.c_str());
        return;
      }
      b.spill_path = path;
      b.data.clear();
      b.data.shrink_to_fit();
      mem_usage_ -= b.size;
      spilled_bytes_ += b.size;
    }
    if (queued) cv_work_.notify_one();
  }

  std::mutex mu_;
  std::condition_variable cv_work_;
  std::condition_variable cv_idle_;
  std::deque<std::shared_ptr<SpillRequest>> queue_;
  std::thread writer_;
  int64_t inflight_ = 0;
  int64_t spilling_bytes_ = 0;  // bytes owned by queued/in-flight writes
  bool stop_ = false;
  std::string spill_dir_;
  int64_t soft_limit_;
  bool async_;
  int64_t next_id_ = 1;
  int64_t mem_usage_ = 0;
  int64_t spilled_bytes_ = 0;   // bytes of completed spill-file writes
  std::unordered_map<int64_t, Block> blocks_;
  std::list<int64_t> lru_;  // front = most recent; only unpinned in-RAM
};

}  // namespace

extern "C" {

void* bs_create(const char* spill_dir, int64_t soft_limit,
                int async_io) {
  return new BlockStore(spill_dir ? spill_dir : "/tmp", soft_limit,
                        async_io != 0);
}

void bs_flush(void* s) { static_cast<BlockStore*>(s)->Flush(); }

int64_t bs_pending(void* s) {
  return static_cast<BlockStore*>(s)->Pending();
}

void bs_destroy(void* s) { delete static_cast<BlockStore*>(s); }

int64_t bs_put(void* s, const void* data, int64_t size) {
  return static_cast<BlockStore*>(s)->Put(data, size);
}

int64_t bs_size(void* s, int64_t id) {
  return static_cast<BlockStore*>(s)->Size(id);
}

int bs_get(void* s, int64_t id, void* out) {
  return static_cast<BlockStore*>(s)->Get(id, out);
}

int bs_pin(void* s, int64_t id) {
  return static_cast<BlockStore*>(s)->Pin(id);
}

int bs_unpin(void* s, int64_t id) {
  return static_cast<BlockStore*>(s)->Unpin(id);
}

void bs_drop(void* s, int64_t id) {
  static_cast<BlockStore*>(s)->Drop(id);
}

int bs_resident(void* s, int64_t id) {
  return static_cast<BlockStore*>(s)->Resident(id);
}

int64_t bs_mem_usage(void* s) {
  return static_cast<BlockStore*>(s)->MemUsage();
}

int64_t bs_spilled_bytes(void* s) {
  return static_cast<BlockStore*>(s)->SpilledBytes();
}

int64_t bs_num_blocks(void* s) {
  return static_cast<BlockStore*>(s)->NumBlocks();
}

}  // extern "C"
