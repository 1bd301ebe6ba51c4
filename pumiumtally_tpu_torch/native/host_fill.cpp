// The staging fill: one pass from a caller's float64 array into a host
// destination in the working dtype (float32 or float64), as
// ``np.copyto(dst, src, casting="unsafe")`` writes it, that also tests
// every written value for Inf/NaN and, given the previous snapshot, whether
// every value equals it (``np.array_equal``: -0.0 == 0.0, NaN never equal).
//
// Arrays of ``kInlineBelow`` elements or more are split into ``kChunk``
// pieces taken in turn by the calling thread and a pool of host threads;
// smaller ones run on the calling thread alone. The pool is made at the
// first threaded fill of a process and remade in a forked child (keyed by
// pid, and dropped by a fork handler), whose parent's threads it never had.
// Plain C interface, loaded with ctypes (which releases the GIL over the
// call). Built without fast-math or -march: the cast rounds to nearest and
// keeps subnormals, as numpy's does.

#include <pthread.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kChunk = 16384;  // elements: 128 KB of float64 read
constexpr int64_t kInlineBelow = 4 * kChunk;

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using U = uint32_t;
  static constexpr U kExp = 0x7f800000u;
};
template <>
struct Bits<double> {
  using U = uint64_t;
  static constexpr U kExp = 0x7ff0000000000000ull;
};

// Flags of one range: bit 0 a non-finite value written, bit 1 a value
// unequal to the snapshot.
template <typename T, bool kPrev>
unsigned fill_range(const double* __restrict src, T* __restrict dst,
                    const T* __restrict prev, int64_t lo, int64_t hi) {
  using U = typename Bits<T>::U;
  U bad = 0;
  U neq = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const T v = static_cast<T>(src[i]);
    dst[i] = v;
    U u;
    std::memcpy(&u, &v, sizeof u);
    bad |= static_cast<U>((u & Bits<T>::kExp) == Bits<T>::kExp);
    if (kPrev) neq |= static_cast<U>(v != prev[i]);
  }
  return (bad ? 1u : 0u) | (neq ? 2u : 0u);
}

struct Job {
  const double* src;
  void* dst;
  const void* prev;
  int64_t n;
  int itemsize;
  std::atomic<int64_t> next{0};
  std::atomic<unsigned> flags{0};

  unsigned range(int64_t lo, int64_t hi) const {
    if (itemsize == 4) {
      auto* d = static_cast<float*>(dst);
      auto* p = static_cast<const float*>(prev);
      return p ? fill_range<float, true>(src, d, p, lo, hi)
               : fill_range<float, false>(src, d, p, lo, hi);
    }
    auto* d = static_cast<double*>(dst);
    auto* p = static_cast<const double*>(prev);
    return p ? fill_range<double, true>(src, d, p, lo, hi)
             : fill_range<double, false>(src, d, p, lo, hi);
  }

  // Take chunks until none is left.
  void work() {
    unsigned f = 0;
    for (;;) {
      const int64_t lo = next.fetch_add(kChunk, std::memory_order_relaxed);
      if (lo >= n) break;
      f |= range(lo, std::min(lo + kChunk, n));
    }
    flags.fetch_or(f, std::memory_order_relaxed);
  }
};

class Pool {
 public:
  const pid_t pid = getpid();

  // Run ``job`` on the calling thread and ``helpers`` pool threads.
  void run(Job* job, int helpers) {
    std::lock_guard<std::mutex> one_job(call_);
    while (static_cast<int>(threads_.size()) < helpers) {
      const int idx = static_cast<int>(threads_.size());
      const uint64_t seen = generation_;  // written only here, under call_
      threads_.emplace_back([this, idx, seen] { loop(idx, seen); });
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = job;
      helpers_ = helpers;
      pending_ = helpers;
      ++generation_;
    }
    start_.notify_all();
    job->work();
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [this] { return pending_ == 0; });
    job_ = nullptr;
  }

 private:
  void loop(int idx, uint64_t seen) {
    for (;;) {
      Job* job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        start_.wait(lk, [&] { return generation_ != seen; });
        seen = generation_;
        if (idx >= helpers_) continue;
        job = job_;
      }
      job->work();
      std::lock_guard<std::mutex> lk(mu_);
      if (--pending_ == 0) done_.notify_one();
    }
  }

  std::mutex call_;  // one job at a time
  std::mutex mu_;
  std::condition_variable start_;
  std::condition_variable done_;
  std::vector<std::thread> threads_;
  Job* job_ = nullptr;
  int helpers_ = 0;
  int pending_ = 0;
  uint64_t generation_ = 0;
};

// The process's pool. Never destroyed: its threads block on it until the
// process exits. A forked child drops its parent's (whose threads it does
// not have, and whose locks another thread may have held) and makes its own.
std::mutex* g_mu = new std::mutex;
Pool* g_pool = nullptr;

void forget_parent_pool() {
  g_mu = new std::mutex;
  g_pool = nullptr;
}

const int g_atfork = pthread_atfork(nullptr, nullptr, forget_parent_pool);

Pool* process_pool() {
  std::lock_guard<std::mutex> lk(*g_mu);
  if (g_pool == nullptr || g_pool->pid != getpid()) g_pool = new Pool;
  return g_pool;
}

}  // namespace

extern "C" {

// Fill ``dst`` (``itemsize`` 4: float32, 8: float64; ``n`` elements) from
// ``src``, comparing with ``prev`` (same dtype, or null). ``threads`` is
// the most threads to use, the caller's included. Returns bit 0: a
// non-finite value was written; bit 1: ``dst`` differs from ``prev``;
// bit 2: the fill ran on pool threads; -1 on a bad argument.
int pumi_host_fill(const double* src, void* dst, const void* prev, int64_t n,
                   int itemsize, int threads) {
  if ((itemsize != 4 && itemsize != 8) || n < 0 || threads < 1) return -1;
  Job job;
  job.src = src;
  job.dst = dst;
  job.prev = prev;
  job.n = n;
  job.itemsize = itemsize;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int helpers =
      static_cast<int>(std::min<int64_t>(threads, chunks)) - 1;
  if (n < kInlineBelow || helpers < 1) {
    return static_cast<int>(job.range(0, n));
  }
  process_pool()->run(&job, helpers);
  return static_cast<int>(job.flags.load()) | 4;
}

int64_t pumi_host_fill_inline_below(void) { return kInlineBelow; }

}  // extern "C"
