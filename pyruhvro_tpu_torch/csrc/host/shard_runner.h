// Copy of pyruhvro_tpu/runtime/native/shard_runner.h, unchanged but for a
// comment that cited the reference's own issue numbers.
//
// Persistent shard-runner thread pool (host tier round 3).
//
// The decode/encode boundaries fan per-shard work out INSIDE one
// GIL-released native call (≙ the reference's
// per_datum_deserialize_threaded fan-out at deserialize.rs:90-121, but
// over row ranges instead of chunk vectors). Before this pool the VM
// spawned fresh std::threads per call — ~100us of create/join per
// fan-out that swamped sub-millisecond chunk decodes and made the
// thread sweep flat (THREAD_SCALING.json r05). The pool keeps workers
// parked on a condition variable between calls, so a fan-out costs one
// notify + one latch wait.
//
// Concurrency design (the TSan flavor runs this):
//   - every shared field transitions under ``m_`` (job_, seq_, stop_,
//     refs); task claiming is a lock-free atomic fetch_add on the
//     job-local ``next`` counter
//   - the caller runs task 0 itself, then drains the claim queue like
//     a worker (with PYRUHVRO_TPU_SHARD_THREADS=1 there are zero
//     workers and the caller runs every task serially)
//   - completion = ``next`` exhausted AND ``refs == 0``: a worker
//     holds a ref (taken under ``m_``) for the whole time it can touch
//     the stack-allocated Job, so run() never returns while any worker
//     can still dereference it
//   - lock order: ``m_`` is a leaf lock (nothing is acquired under it)
//   - fork hygiene: a forked child inherits no threads; run() detects
//     the pid change and resets the worker book-keeping instead of
//     waiting on threads that do not exist
//
// This header is pure C++ (no Python.h): the GIL is the caller's
// problem — decode/encode boundaries release it around run().
#ifndef PYRUHVRO_SHARD_RUNNER_H_
#define PYRUHVRO_SHARD_RUNNER_H_

#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace pyr {
namespace shard {

// PYRUHVRO_TPU_SHARD_THREADS: cap on the per-call shard count (and so
// on the pool's worker population). 0 / unset = auto.
inline int env_threads_cap() {
  const char* s = std::getenv("PYRUHVRO_TPU_SHARD_THREADS");
  if (s == nullptr || *s == '\0') return 0;
  int v = std::atoi(s);
  return v > 0 ? v : 0;
}

class Pool {
 public:
  // One pool per extension module (each .so is its own translation
  // unit under RTLD_LOCAL); workers are joined on static destruction.
  static Pool& instance() {
    static Pool p;
    return p;
  }

  // Run fn(0..nt-1), blocking until every task finished. The caller
  // executes task 0 (and then steals from the queue); tasks 1..nt-1
  // are claimed by parked workers. Reentrant calls are not supported
  // (the decode boundary is the only caller and never nests).
  template <class Fn>
  void run(int nt, Fn&& fn) {
    if (nt <= 1) {
      fn(0);
      return;
    }
    std::function<void(int)> f(std::forward<Fn>(fn));
    Job job;
    job.fn = &f;
    job.nt = nt;
    job.next.store(1, std::memory_order_relaxed);
    {
      std::lock_guard<std::mutex> lk(m_);
      reset_after_fork_locked();
      ensure_workers_locked(nt - 1);
      job_ = &job;
      seq_++;
    }
    cv_.notify_all();
    f(0);
    drain(job);
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return job.refs == 0; });
    job_ = nullptr;
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) {
      if (t.joinable()) t.join();
    }
  }

 private:
  struct Job {
    const std::function<void(int)>* fn = nullptr;
    int nt = 0;
    std::atomic<int> next{1};
    int refs = 0;  // guarded by Pool::m_
  };

  void drain(Job& job) {
    for (;;) {
      int i = job.next.fetch_add(1, std::memory_order_relaxed);
      if (i >= job.nt) return;
      (*job.fn)(i);
    }
  }

  void worker_loop() {
    unsigned long long seen = 0;
    for (;;) {
      Job* job = nullptr;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] {
          return stop_ || (seq_ != seen && job_ != nullptr);
        });
        if (stop_) return;
        seen = seq_;
        job = job_;
        job->refs++;
      }
      drain(*job);
      {
        std::lock_guard<std::mutex> lk(m_);
        if (--job->refs == 0) done_cv_.notify_all();
      }
    }
  }

  void ensure_workers_locked(int want) {
    if (want > kMaxWorkers) want = kMaxWorkers;
    while ((int)threads_.size() < want)
      threads_.emplace_back([this] { worker_loop(); });
  }

  void reset_after_fork_locked() {
    pid_t pid = ::getpid();
    if (pid_ == pid) return;
    // inherited std::thread objects refer to threads that do not exist
    // in this process: detach the handles so their destructors don't
    // terminate(), and respawn lazily
    for (auto& t : threads_) {
      if (t.joinable()) t.detach();
    }
    threads_.clear();
    job_ = nullptr;
    pid_ = pid;
  }

  static constexpr int kMaxWorkers = 63;

  std::mutex m_;
  std::condition_variable cv_;       // workers park here
  std::condition_variable done_cv_;  // run() waits for refs == 0 here
  std::vector<std::thread> threads_;  // guarded by m_
  Job* job_ = nullptr;                // guarded by m_
  unsigned long long seq_ = 0;        // guarded by m_
  bool stop_ = false;                 // guarded by m_
  pid_t pid_ = ::getpid();            // guarded by m_
};

// ---- cumulative fan-out stats (drained by Python shard_stats()) ------
//
// One record per run_all_shards/encode fan-out: Python's fanout_stats
// computes pool.chunk_efficiency from (shard busy seconds, wall, shard
// count) without a per-shard Python call ever existing.
struct StatsSnap {
  unsigned long long fanouts = 0;
  unsigned long long shards = 0;
  double shard_s = 0.0;  // summed per-shard busy seconds
  double wall_s = 0.0;   // summed fan-out region walls
  int last_threads = 0;
};

class Stats {
 public:
  static Stats& instance() {
    static Stats s;
    return s;
  }

  void record(int nt, double wall_s, const double* shard_s, int n) {
    double busy = 0.0;
    for (int i = 0; i < n; i++) busy += shard_s[i];
    std::lock_guard<std::mutex> lk(m_);
    snap_.fanouts++;
    snap_.shards += (unsigned long long)nt;
    snap_.shard_s += busy;
    snap_.wall_s += wall_s;
    snap_.last_threads = nt;
  }

  StatsSnap drain() {  // snapshot-and-clear, like prof::drain_py
    std::lock_guard<std::mutex> lk(m_);
    StatsSnap out = snap_;
    snap_ = StatsSnap{};
    return out;
  }

 private:
  std::mutex m_;        // leaf lock
  StatsSnap snap_;      // guarded by m_
};

inline double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace shard
}  // namespace pyr

#endif  // PYRUHVRO_SHARD_RUNNER_H_
