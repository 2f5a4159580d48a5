// Native async I/O engine: epoll event loop on a dedicated thread.
//
// The port's copy of the reference package's native/dispatcher.cpp
// (Thrill: thrill/net/dispatcher.hpp:510, AsyncRead/AsyncWrite of
// buffers queued per connection; dispatcher_thread.hpp:60, the
// dedicated thread driving the loop). The host control plane (the TCP
// group, thrill_tpu_torch/net/tcp.py) hands byte buffers to this engine
// so sends to many peers progress concurrently while the worker thread
// computes. Completions are polled and awaited from Python by request
// id (net/dispatcher.py), not delivered as C callbacks: Python owns
// scheduling, C++ owns bytes and the event loop.
//
// Request lifecycle: async_write borrows the buffer, async_read records
// a want-length; the loop moves bytes whenever epoll reports readiness,
// retiring requests FIFO per fd per direction. disp_wait blocks on a
// condition variable; fetch copies a completed read's bytes out and
// frees the slot.
//
// Build (thrill_tpu_torch/common/native_build.py load_host does it at
// first use): g++ -O3 -shared -fPIC -std=c++17 -pthread dispatcher.cpp

#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>
#include <fcntl.h>
#include <errno.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct WriteReq {
  int64_t id = 0;
  // borrowed buffer: the caller guarantees it stays valid until the
  // request completes (the Python wrapper pins the immutable bytes
  // object until fetch) — enqueue is zero-copy even for huge frames
  const char* data = nullptr;
  size_t len = 0;
  size_t off = 0;
};

struct ReadReq {
  int64_t id = 0;
  std::vector<char> data;   // filled up to got
  size_t want = 0;
  size_t got = 0;
};

struct FdState {
  int fd = -1;
  std::deque<WriteReq> writes;
  std::deque<ReadReq> reads;
  uint32_t events = 0;      // current epoll interest set
  bool error = false;
  // fd removed from the epoll set: a bare EPOLLHUP/EPOLLERR is
  // level-triggered and reported regardless of the interest mask, so
  // an idle hung-up fd must leave the set or the loop busy-spins. A
  // later request re-adds it (buffered bytes are still readable).
  bool parked = false;
};

// completed request: status >0 ok (bytes), <0 error (-errno or -1 eof)
struct Done {
  int64_t status = 0;
  std::vector<char> data;   // read payload (empty for writes)
};

class Dispatcher {
 public:
  Dispatcher() {
    epfd_ = epoll_create1(EPOLL_CLOEXEC);
    if (pipe2(wake_, O_NONBLOCK | O_CLOEXEC) != 0) {
      wake_[0] = wake_[1] = -1;
    }
    if (epfd_ >= 0 && wake_[0] >= 0) {
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = wake_[0];
      epoll_ctl(epfd_, EPOLL_CTL_ADD, wake_[0], &ev);
      loop_ = std::thread([this] { Run(); });
      running_ = true;
    }
  }

  ~Dispatcher() {
    if (running_) {
      stop_.store(true);
      Wake();
      loop_.join();
    }
    if (epfd_ >= 0) close(epfd_);
    if (wake_[0] >= 0) { close(wake_[0]); close(wake_[1]); }
  }

  bool ok() const { return running_; }

  int Register(int fd) {
    std::lock_guard<std::mutex> g(mu_);
    if (fds_.count(fd)) return -1;       // before any fd-mode change
    int flags = fcntl(fd, F_GETFL, 0);
    if (flags < 0 || fcntl(fd, F_SETFL, flags | O_NONBLOCK) < 0) return -1;
    FdState st;
    st.fd = fd;
    fds_.emplace(fd, std::move(st));
    epoll_event ev{};
    ev.events = 0;
    ev.data.fd = fd;
    if (epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev) != 0) {
      fds_.erase(fd);
      fcntl(fd, F_SETFL, flags);         // restore blocking mode
      return -1;
    }
    return 0;
  }

  // Drop the fd from the engine. Pending requests complete with error;
  // the fd is restored to blocking mode for the caller's further use.
  int Unregister(int fd) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = fds_.find(fd);
    if (it == fds_.end()) return -1;
    for (auto& w : it->second.writes) Retire(w.id, -EPIPE, {});
    for (auto& r : it->second.reads) Retire(r.id, -EPIPE, {});
    epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr);
    fds_.erase(it);
    lk.unlock();
    int flags = fcntl(fd, F_GETFL, 0);
    if (flags >= 0) fcntl(fd, F_SETFL, flags & ~O_NONBLOCK);
    cv_.notify_all();
    return 0;
  }

  int64_t AsyncWrite(int fd, const char* buf, int64_t len) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = fds_.find(fd);
    if (it == fds_.end() || it->second.error) return -1;
    FdState& st = it->second;
    int64_t id = next_id_++;
    size_t off = 0;
    if (st.writes.empty()) {
      // opportunistic inline send while the queue is empty (FIFO-safe):
      // a few attempts fill the socket buffer at caller speed — small
      // frames usually complete here — but the attempt cap keeps the
      // caller's enqueue latency bounded so a continuously-draining
      // receiver cannot turn the async send into a full blocking one
      for (int attempts = 0;
           off < static_cast<size_t>(len) && attempts < 4; attempts++) {
        ssize_t n = send(fd, buf + off, len - off, MSG_NOSIGNAL);
        if (n < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          if (errno == EINTR) continue;
          Retire(id, -errno, {});
          FailAll(st, -errno);
          return id;
        }
        off += static_cast<size_t>(n);
      }
      if (off == static_cast<size_t>(len)) {
        Retire(id, std::max<int64_t>(len, 1), {});
        cv_.notify_all();
        return id;
      }
    }
    WriteReq req;
    req.id = id;
    req.data = buf;
    req.len = static_cast<size_t>(len);
    req.off = off;
    st.writes.push_back(req);
    UpdateInterest(st);
    Wake();
    return id;
  }

  int64_t AsyncRead(int fd, int64_t len) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = fds_.find(fd);
    if (it == fds_.end() || it->second.error) return -1;
    int64_t id = next_id_++;
    if (len == 0 && it->second.reads.empty()) {
      // zero-byte read with nothing queued ahead completes right away
      // (epoll never fires for it; matches blocking recv_exact(0))
      Retire(id, 1, {});
      cv_.notify_all();
      return id;
    }
    ReadReq req;
    req.id = id;
    req.want = static_cast<size_t>(len);
    req.data.resize(req.want);
    it->second.reads.push_back(std::move(req));
    UpdateInterest(it->second);
    Wake();
    return id;
  }

  // 0 = pending, 1 = done ok, negative = error status
  int64_t Poll(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = done_.find(id);
    if (it == done_.end()) return 0;
    return it->second.status > 0 ? 1 : it->second.status;
  }

  int64_t Wait(int64_t id, double timeout_s) {
    std::unique_lock<std::mutex> lk(mu_);
    auto pred = [&] { return done_.count(id) > 0; };
    if (timeout_s < 0) {
      cv_.wait(lk, pred);
    } else {
      // wait_until(system_clock), not wait_for: wait_for waits on the
      // steady clock, which libstdc++ lowers to pthread_cond_clockwait
      // — a call this toolchain's libtsan does not intercept, so TSan
      // loses track of the condvar's internal unlock/relock and
      // reports a bogus "double lock of a mutex" on the next acquire.
      // pthread_cond_timedwait (what system_clock waits use) is
      // intercepted. A wall-clock step can stretch/shrink the timeout;
      // completion wakeups are condvar-signaled either way.
      auto deadline = std::chrono::system_clock::now() +
                      std::chrono::microseconds(
                          static_cast<int64_t>(timeout_s * 1e6));
      if (!cv_.wait_until(lk, deadline, pred))
        return 0;  // timeout, still pending
    }
    auto& d = done_[id];
    return d.status > 0 ? 1 : d.status;
  }

  // copy a completed request's read bytes out and free the slot;
  // returns bytes copied (0 for writes), negative error status, or
  // kNotDone for an id with no completion yet (distinct from the -1
  // EOF status so callers can tell "still pending" from "failed")
  static constexpr int64_t kNotDone = -(int64_t(1) << 62);

  int64_t Fetch(int64_t id, char* out, int64_t cap) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = done_.find(id);
    if (it == done_.end()) return kNotDone;
    Done d = std::move(it->second);
    done_.erase(it);
    if (d.status < 0) return d.status;
    int64_t n = static_cast<int64_t>(d.data.size());
    if (n > 0 && out != nullptr && cap >= n)
      std::memcpy(out, d.data.data(), static_cast<size_t>(n));
    else if (n > cap)
      return -EMSGSIZE;
    return n;
  }

  int64_t PendingCount() {
    std::lock_guard<std::mutex> g(mu_);
    int64_t n = 0;
    for (auto& kv : fds_)
      n += static_cast<int64_t>(kv.second.writes.size() +
                                kv.second.reads.size());
    return n;
  }

 private:
  void Wake() {
    char b = 1;
    if (wake_[1] >= 0) { ssize_t r = write(wake_[1], &b, 1); (void)r; }
  }

  // caller holds mu_
  void Retire(int64_t id, int64_t status, std::vector<char>&& data) {
    Done d;
    d.status = status;
    d.data = std::move(data);
    done_.emplace(id, std::move(d));
  }

  // caller holds mu_
  void UpdateInterest(FdState& st) {
    uint32_t want = 0;
    if (!st.reads.empty()) want |= EPOLLIN;
    if (!st.writes.empty()) want |= EPOLLOUT;
    if (st.parked) {
      if (want == 0) return;
      epoll_event ev{};
      ev.events = want;
      ev.data.fd = st.fd;
      if (epoll_ctl(epfd_, EPOLL_CTL_ADD, st.fd, &ev) == 0) {
        st.parked = false;
        st.events = want;
      }
      return;
    }
    if (want == st.events) return;
    epoll_event ev{};
    ev.events = want;
    ev.data.fd = st.fd;
    epoll_ctl(epfd_, EPOLL_CTL_MOD, st.fd, &ev);
    st.events = want;
  }

  // caller holds mu_: drop the fd from the epoll set (see FdState)
  void Park(FdState& st) {
    if (st.parked) return;
    epoll_ctl(epfd_, EPOLL_CTL_DEL, st.fd, nullptr);
    st.parked = true;
    st.events = 0;
  }

  void HandleWritable(FdState& st) {
    while (!st.writes.empty()) {
      WriteReq& w = st.writes.front();
      ssize_t n = send(st.fd, w.data + w.off, w.len - w.off,
                       MSG_NOSIGNAL);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        if (errno == EINTR) continue;
        FailAll(st, -errno);
        return;
      }
      w.off += static_cast<size_t>(n);
      if (w.off < w.len) return;
      // zero-length writes still report success (status must be > 0)
      Retire(w.id, std::max<int64_t>(static_cast<int64_t>(w.len), 1), {});
      st.writes.pop_front();
      cv_.notify_all();
    }
  }

  void HandleReadable(FdState& st) {
    while (!st.reads.empty()) {
      ReadReq& r = st.reads.front();
      if (r.want == 0) {
        Retire(r.id, 1, {});
        st.reads.pop_front();
        cv_.notify_all();
        continue;
      }
      ssize_t n = recv(st.fd, r.data.data() + r.got, r.want - r.got, 0);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        if (errno == EINTR) continue;
        FailAll(st, -errno);
        return;
      }
      if (n == 0) {  // peer closed mid-request
        FailAll(st, -1);
        return;
      }
      r.got += static_cast<size_t>(n);
      if (r.got < r.want) return;
      Retire(r.id, static_cast<int64_t>(r.want), std::move(r.data));
      st.reads.pop_front();
      cv_.notify_all();
    }
  }

  // caller holds mu_
  void FailAll(FdState& st, int64_t status) {
    st.error = true;
    for (auto& w : st.writes) Retire(w.id, status, {});
    for (auto& r : st.reads) Retire(r.id, status, {});
    st.writes.clear();
    st.reads.clear();
    Park(st);  // errored fds keep reporting HUP/ERR — leave the set
    cv_.notify_all();
  }

  void Run() {
    std::vector<epoll_event> evs(64);
    while (!stop_.load()) {
      int n = epoll_wait(epfd_, evs.data(), static_cast<int>(evs.size()),
                         200 /*ms: bounded stop latency*/);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      std::lock_guard<std::mutex> g(mu_);
      for (int i = 0; i < n; i++) {
        int fd = evs[i].data.fd;
        if (fd == wake_[0]) {
          char buf[256];
          while (read(wake_[0], buf, sizeof buf) > 0) {}
          continue;
        }
        auto it = fds_.find(fd);
        if (it == fds_.end()) continue;
        FdState& st = it->second;
        if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
          // a hangup is NOT an error for this fd's buffered data:
          // drain pending reads (recv returns the peer's final bytes,
          // then 0 -> EOF fails only reads that cannot complete) and
          // let pending writes fail through send() itself. An idle fd
          // is parked so the level-triggered HUP stops firing; a later
          // async_read re-adds it and still sees the kernel buffer.
          HandleReadable(st);
          HandleWritable(st);
          if (!st.error && st.reads.empty() && st.writes.empty())
            Park(st);
          continue;
        }
        if (evs[i].events & EPOLLOUT) HandleWritable(st);
        if (evs[i].events & EPOLLIN) HandleReadable(st);
        UpdateInterest(st);
      }
    }
  }

  int epfd_ = -1;
  int wake_[2] = {-1, -1};
  std::thread loop_;
  bool running_ = false;
  std::atomic<bool> stop_{false};
  std::mutex mu_;
  std::condition_variable cv_;
  std::unordered_map<int, FdState> fds_;
  std::unordered_map<int64_t, Done> done_;
  int64_t next_id_ = 1;
};

}  // namespace

extern "C" {

void* disp_create() {
  auto* d = new Dispatcher();
  if (!d->ok()) {
    delete d;
    return nullptr;
  }
  return d;
}

void disp_destroy(void* h) { delete static_cast<Dispatcher*>(h); }

int disp_register(void* h, int fd) {
  return static_cast<Dispatcher*>(h)->Register(fd);
}

int disp_unregister(void* h, int fd) {
  return static_cast<Dispatcher*>(h)->Unregister(fd);
}

int64_t disp_async_write(void* h, int fd, const char* buf, int64_t len) {
  return static_cast<Dispatcher*>(h)->AsyncWrite(fd, buf, len);
}

int64_t disp_async_read(void* h, int fd, int64_t len) {
  return static_cast<Dispatcher*>(h)->AsyncRead(fd, len);
}

int64_t disp_poll(void* h, int64_t id) {
  return static_cast<Dispatcher*>(h)->Poll(id);
}

int64_t disp_wait(void* h, int64_t id, double timeout_s) {
  return static_cast<Dispatcher*>(h)->Wait(id, timeout_s);
}

int64_t disp_fetch(void* h, int64_t id, char* out, int64_t cap) {
  return static_cast<Dispatcher*>(h)->Fetch(id, out, cap);
}

int64_t disp_pending(void* h) {
  return static_cast<Dispatcher*>(h)->PendingCount();
}

}  // extern "C"
