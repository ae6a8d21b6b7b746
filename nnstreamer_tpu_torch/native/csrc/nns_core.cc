// Native host-runtime core for nnstreamer_tpu.
//
// Reference analogs (all C in the reference tree):
//   * aligned buffer pool  <- gst/nnstreamer/tensor_allocator.c (custom
//     GstAllocator with forced alignment) + GstBufferPool reuse semantics.
//   * SPSC ring            <- GStreamer `queue` element's bounded GQueue —
//     the reference's only stage-parallelism primitive (SURVEY.md §3.2).
//   * repo prefetch reader <- gst/datarepo/gstdatareposrc.c sample reads;
//     redesigned: a native reader thread preads samples ahead of the
//     pipeline into pooled aligned blocks so Python (GIL-bound) never
//     blocks on disk I/O — double-buffered host staging for the TPU feed.
//
// C ABI only (consumed via ctypes). No Python.h dependency: the boundary
// passes raw pointers + sizes; Python wraps them as numpy arrays.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see Makefile).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#define NNS_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr size_t kDefaultAlign = 64;  // cacheline; DMA-friendly

// ---------------------------------------------------------------------------
// Aligned buffer pool
// ---------------------------------------------------------------------------

struct Pool {
  size_t block_size;
  size_t alignment;
  std::mutex mu;
  std::vector<void *> free_list;   // blocks ready for reuse
  std::vector<void *> all_blocks;  // everything we ever allocated
  size_t max_blocks;               // 0 = unbounded growth
  std::atomic<uint64_t> acquires{0};
  std::atomic<uint64_t> reuses{0};

  ~Pool() {
    for (void *p : all_blocks) std::free(p);
  }
};

void *aligned_block(size_t size, size_t alignment) {
  void *p = nullptr;
  size_t rounded = (size + alignment - 1) / alignment * alignment;
  if (posix_memalign(&p, alignment, rounded) != 0) return nullptr;
  return p;
}

// ---------------------------------------------------------------------------
// SPSC ring of {data, size, tag} records
// ---------------------------------------------------------------------------

struct RingSlot {
  void *data;
  uint64_t size;
  uint64_t tag;
};

struct Ring {
  explicit Ring(size_t capacity) : slots(capacity + 1) {}
  std::vector<RingSlot> slots;  // one slot kept empty to distinguish full/empty
  std::atomic<size_t> head{0};  // consumer position
  std::atomic<size_t> tail{0};  // producer position
  std::mutex mu;                // only for the blocking waits
  std::condition_variable cv_put, cv_get;
  std::atomic<bool> closed{false};

  size_t next(size_t i) const { return (i + 1) % slots.size(); }

  bool push(const RingSlot &s, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    auto full = [&] { return next(tail.load()) == head.load(); };
    if (full()) {
      auto pred = [&] { return !full() || closed.load(); };
      if (timeout_ms < 0) {
        cv_put.wait(lk, pred);
      } else if (!cv_put.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred)) {
        return false;
      }
    }
    if (closed.load()) return false;
    slots[tail.load()] = s;
    tail.store(next(tail.load()));
    cv_get.notify_one();
    return true;
  }

  // returns: 1 popped, 0 timeout, -1 closed-and-drained
  int pop(RingSlot *out, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    auto empty = [&] { return head.load() == tail.load(); };
    if (empty()) {
      auto pred = [&] { return !empty() || closed.load(); };
      if (timeout_ms < 0) {
        cv_get.wait(lk, pred);
      } else if (!cv_get.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred)) {
        return 0;
      }
    }
    if (empty()) return closed.load() ? -1 : 0;
    *out = slots[head.load()];
    head.store(next(head.load()));
    cv_put.notify_one();
    return 1;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu);
    closed.store(true);
    cv_put.notify_all();
    cv_get.notify_all();
  }
};

// ---------------------------------------------------------------------------
// Datarepo prefetch reader
// ---------------------------------------------------------------------------

struct RepoReader {
  int fd = -1;
  size_t sample_size = 0;
  std::vector<uint64_t> order;  // sample indices, in emission order
  Pool *pool = nullptr;         // borrowed, not owned
  Ring ring;
  std::thread worker;
  std::atomic<bool> stop_flag{false};
  std::atomic<int> error{0};

  explicit RepoReader(size_t depth) : ring(depth) {}
};

}  // namespace

// ---------------------------------------------------------------------------
// Pool C ABI
// ---------------------------------------------------------------------------

NNS_API void *nns_pool_create(uint64_t block_size, uint64_t alignment,
                              uint64_t max_blocks) {
  auto *p = new Pool();
  p->block_size = block_size;
  p->alignment = alignment ? alignment : kDefaultAlign;
  p->max_blocks = max_blocks;
  return p;
}

NNS_API void *nns_pool_acquire(void *pool) {
  auto *p = static_cast<Pool *>(pool);
  p->acquires.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    if (!p->free_list.empty()) {
      void *b = p->free_list.back();
      p->free_list.pop_back();
      p->reuses.fetch_add(1);
      return b;
    }
    if (p->max_blocks && p->all_blocks.size() >= p->max_blocks) return nullptr;
  }
  void *b = aligned_block(p->block_size, p->alignment);
  if (b) {
    std::lock_guard<std::mutex> lk(p->mu);
    p->all_blocks.push_back(b);
  }
  return b;
}

NNS_API void nns_pool_release(void *pool, void *block) {
  auto *p = static_cast<Pool *>(pool);
  std::lock_guard<std::mutex> lk(p->mu);
  p->free_list.push_back(block);
}

NNS_API uint64_t nns_pool_stats(void *pool, uint64_t *reuses) {
  auto *p = static_cast<Pool *>(pool);
  if (reuses) *reuses = p->reuses.load();
  return p->acquires.load();
}

NNS_API void nns_pool_destroy(void *pool) { delete static_cast<Pool *>(pool); }

// ---------------------------------------------------------------------------
// Ring C ABI
// ---------------------------------------------------------------------------

NNS_API void *nns_ring_create(uint64_t capacity) { return new Ring(capacity); }

NNS_API int nns_ring_push(void *ring, void *data, uint64_t size, uint64_t tag,
                          int64_t timeout_ms) {
  return static_cast<Ring *>(ring)->push({data, size, tag}, timeout_ms) ? 1 : 0;
}

NNS_API int nns_ring_pop(void *ring, void **data, uint64_t *size, uint64_t *tag,
                         int64_t timeout_ms) {
  RingSlot s;
  int r = static_cast<Ring *>(ring)->pop(&s, timeout_ms);
  if (r == 1) {
    *data = s.data;
    *size = s.size;
    *tag = s.tag;
  }
  return r;
}

NNS_API void nns_ring_close(void *ring) { static_cast<Ring *>(ring)->close(); }

NNS_API void nns_ring_destroy(void *ring) { delete static_cast<Ring *>(ring); }

// ---------------------------------------------------------------------------
// Gather / scatter memcpy helpers (multi-tensor frame <-> contiguous wire
// payload without Python-level byte joins)
// ---------------------------------------------------------------------------

NNS_API void nns_memcpy_gather(void *dst, void **parts, uint64_t *sizes,
                               uint64_t n) {
  char *out = static_cast<char *>(dst);
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(out, parts[i], sizes[i]);
    out += sizes[i];
  }
}

NNS_API void nns_memcpy_scatter(void *src, void **parts, uint64_t *sizes,
                                uint64_t n) {
  const char *in = static_cast<const char *>(src);
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(parts[i], in, sizes[i]);
    in += sizes[i];
  }
}

// ---------------------------------------------------------------------------
// Repo prefetch reader C ABI
// ---------------------------------------------------------------------------

NNS_API void *nns_repo_open(const char *path, uint64_t sample_size,
                            const uint64_t *order, uint64_t n_order,
                            void *pool, uint64_t prefetch_depth) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto *r = new RepoReader(prefetch_depth ? prefetch_depth : 4);
  r->fd = fd;
  r->sample_size = sample_size;
  r->order.assign(order, order + n_order);
  r->pool = static_cast<Pool *>(pool);

  r->worker = std::thread([r] {
    for (uint64_t idx : r->order) {
      if (r->stop_flag.load()) break;
      void *block = nns_pool_acquire(r->pool);
      while (block == nullptr && !r->stop_flag.load()) {
        // pool exhausted (consumer owns all blocks): brief backoff
        std::this_thread::sleep_for(std::chrono::microseconds(200));
        block = nns_pool_acquire(r->pool);
      }
      if (block == nullptr) break;
      size_t done = 0;
      off_t base = static_cast<off_t>(idx) * r->sample_size;
      bool ok = true;
      while (done < r->sample_size) {
        ssize_t got = ::pread(r->fd, static_cast<char *>(block) + done,
                              r->sample_size - done, base + done);
        if (got <= 0) {
          ok = false;
          break;
        }
        done += got;
      }
      if (!ok) {
        nns_pool_release(r->pool, block);
        r->error.store(1);
        break;
      }
      if (!r->ring.push({block, r->sample_size, idx}, -1)) {
        nns_pool_release(r->pool, block);
        break;
      }
    }
    r->ring.close();
  });
  return r;
}

// returns 1 (sample ready), 0 (timeout), -1 (end of order / error; check
// nns_repo_error)
NNS_API int nns_repo_next(void *reader, void **data, uint64_t *idx,
                          int64_t timeout_ms) {
  auto *r = static_cast<RepoReader *>(reader);
  RingSlot s;
  int got = r->ring.pop(&s, timeout_ms);
  if (got == 1) {
    *data = s.data;
    *idx = s.tag;
  }
  return got;
}

NNS_API void nns_repo_release(void *reader, void *block) {
  auto *r = static_cast<RepoReader *>(reader);
  nns_pool_release(r->pool, block);
}

NNS_API int nns_repo_error(void *reader) {
  return static_cast<RepoReader *>(reader)->error.load();
}

// Unblock both sides (producer + a consumer stuck in nns_repo_next) without
// freeing anything. Safe to call from a thread other than the consumer;
// the consumer sees end-of-stream on its next pop. Call before join/close.
NNS_API void nns_repo_cancel(void *reader) {
  auto *r = static_cast<RepoReader *>(reader);
  r->stop_flag.store(true);
  r->ring.close();
}

NNS_API void nns_repo_close(void *reader) {
  auto *r = static_cast<RepoReader *>(reader);
  r->stop_flag.store(true);
  r->ring.close();
  // drain anything the worker already queued so blocks return to the pool
  RingSlot s;
  while (r->ring.pop(&s, 0) == 1) nns_pool_release(r->pool, s.data);
  if (r->worker.joinable()) r->worker.join();
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

NNS_API uint64_t nns_abi_version() { return 1; }
