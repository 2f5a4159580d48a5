// ThreadSanitizer stress harness for the port's multithreaded native
// components: the epoll dispatcher (its event-loop thread against API
// callers) and the block store (its async spill-writer thread against
// put/get/pin/drop callers).
//
// The port's copy of the reference package's native/tsan_stress.cpp. The
// reference framework runs TSan in its CI for this class of code
// (thrill/CMakeLists.txt:129-131); Python-driven tests cannot give the
// native threads that coverage, so this is a standalone binary:
// tests/test_torch_tsan.py compiles it together with the port's
// dispatcher.cpp and blockstore.cpp under -fsanitize=thread and asserts a
// clean run (TSan exits non-zero on a detected race with halt_on_error,
// and its reports go to stderr).
//
// Build (the test does this):
//   g++ -O1 -g -fsanitize=thread -pthread -std=c++17 \
//       thrill_tpu_torch/native/tsan_stress.cpp -o tsan_stress
// (dispatcher.cpp and blockstore.cpp are #included, so their internal
// classes are compiled into the instrumented binary directly.)

#include <atomic>
#include <cstdio>
#include <cstring>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include "dispatcher.cpp"
#include "blockstore.cpp"

namespace {

int stress_dispatcher() {
  void* d = disp_create();
  if (!d) {
    std::fprintf(stderr, "disp_create failed\n");
    return 1;
  }
  constexpr int kPairs = 4;
  constexpr int kRounds = 60;
  int fds[kPairs][2];
  for (auto& p : fds) {
    if (socketpair(AF_UNIX, SOCK_STREAM, 0, p) != 0) return 1;
    disp_register(d, p[0]);
    disp_register(d, p[1]);
  }
  std::atomic<int> failures{0};
  std::vector<std::thread> threads;
  // per pair: one thread writes bursts into side 0, one reads from
  // side 1 — API calls race against the epoll loop thread's handling
  for (int pi = 0; pi < kPairs; ++pi) {
    threads.emplace_back([&, pi] {
      std::string blob(1 << 15, static_cast<char>('a' + pi));
      std::vector<int64_t> ids;
      for (int r = 0; r < kRounds; ++r) {
        int64_t id = disp_async_write(d, fds[pi][0], blob.data(),
                                      static_cast<int64_t>(blob.size()));
        if (id < 0) failures.fetch_add(1);
        else ids.push_back(id);
      }
      // BORROW CONTRACT: the buffer must outlive its sends (the
      // Python side pins borrowed buffers until flush() for the same
      // reason) — the first version of this harness dropped blob at
      // thread exit with writes still queued, and TSan correctly
      // flagged the recycled-memory read in the loop thread
      for (int64_t id : ids) {
        if (disp_wait(d, id, 30.0) < 0) failures.fetch_add(1);
      }
    });
    threads.emplace_back([&, pi] {
      std::vector<char> buf(1 << 15);
      for (int r = 0; r < kRounds; ++r) {
        int64_t id = disp_async_read(d, fds[pi][1],
                                     static_cast<int64_t>(buf.size()));
        if (id < 0 || disp_wait(d, id, 30.0) < 0 ||
            disp_fetch(d, id, buf.data(),
                       static_cast<int64_t>(buf.size())) !=
                static_cast<int64_t>(buf.size())) {
          failures.fetch_add(1);
          continue;
        }
        for (char c : buf) {
          if (c != 'a' + pi) {
            failures.fetch_add(1);
            break;
          }
        }
      }
    });
  }
  // a churn thread registers/unregisters an unrelated pair while the
  // loop thread is busy — the registration path races the event loop
  threads.emplace_back([&] {
    for (int r = 0; r < 40; ++r) {
      int p[2];
      if (socketpair(AF_UNIX, SOCK_STREAM, 0, p) != 0) continue;
      disp_register(d, p[0]);
      disp_register(d, p[1]);
      const char one = 'x';
      disp_async_write(d, p[0], &one, 1);
      int64_t rid = disp_async_read(d, p[1], 1);
      char c;
      disp_wait(d, rid, 30.0);
      disp_fetch(d, rid, &c, 1);
      disp_unregister(d, p[0]);
      disp_unregister(d, p[1]);
      close(p[0]);
      close(p[1]);
    }
  });
  for (auto& t : threads) t.join();
  for (auto& p : fds) {
    disp_unregister(d, p[0]);
    disp_unregister(d, p[1]);
    close(p[0]);
    close(p[1]);
  }
  disp_destroy(d);
  if (failures.load()) {
    std::fprintf(stderr, "dispatcher stress: %d logical failures\n",
                 failures.load());
    return 1;
  }
  return 0;
}

int stress_blockstore(const char* dir) {
  // tiny soft limit forces the async spill thread to run constantly
  void* s = bs_create(dir, 1 << 16, /*async_io=*/1);
  if (!s) return 1;
  constexpr int kThreads = 4;
  constexpr int kOps = 250;
  std::atomic<int> failures{0};
  std::vector<std::thread> threads;
  for (int ti = 0; ti < kThreads; ++ti) {
    threads.emplace_back([&, ti] {
      std::vector<int64_t> mine;
      std::string payload(4096, static_cast<char>('A' + ti));
      std::vector<char> out(payload.size());
      for (int i = 0; i < kOps; ++i) {
        int64_t id = bs_put(s, payload.data(),
                            static_cast<int64_t>(payload.size()));
        if (id < 0) {
          failures.fetch_add(1);
          continue;
        }
        mine.push_back(id);
        // read back an older block (may already be spilled by the
        // writer thread -> exercises the reload path under pin)
        int64_t victim = mine[mine.size() / 2];
        if (bs_pin(s, victim) == 0) {
          if (bs_size(s, victim) !=
                  static_cast<int64_t>(payload.size()) ||
              bs_get(s, victim, out.data()) != 0 ||
              std::memcmp(out.data(), payload.data(),
                          payload.size()) != 0) {
            failures.fetch_add(1);
          }
          bs_unpin(s, victim);
        }
        if (i % 7 == 0 && mine.size() > 4) {
          bs_drop(s, mine.front());
          mine.erase(mine.begin());
        }
      }
      for (int64_t id : mine) bs_drop(s, id);
    });
  }
  for (auto& t : threads) t.join();
  bs_flush(s);
  bs_destroy(s);
  if (failures.load()) {
    std::fprintf(stderr, "blockstore stress: %d logical failures\n",
                 failures.load());
    return 1;
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* dir = argc > 1 ? argv[1] : "/tmp";
  int rc = stress_dispatcher();
  rc |= stress_blockstore(dir);
  if (rc == 0) std::printf("TSAN_STRESS_OK\n");
  return rc;
}
