// Threaded dependency engine — versioned vars, read/write dependency
// tracking, priority worker pool, async exception propagation.
//
// The port's copy of mxnet_tpu's native engine (native/src/engine.h),
// built by mxnet_tpu_torch/native.py.  Upstream MXNet's
// src/engine/threaded_engine.cc and naive_engine.cc hold the semantics:
//   * every var is versioned; writers are serialized per var, readers run
//     concurrently between writes (multi-reader single-writer per var);
//   * ops are pushed with (const_vars, mutate_vars) and dispatch when all
//     dependencies are satisfied; completion bumps mutate-var versions and
//     unblocks dependents;
//   * exceptions raised by an op are stored on its mutate vars, propagate
//     through dependent ops without running them, and rethrow at
//     WaitForVar/WaitForAll sync points;
//   * NaiveEngine mode executes synchronously in the caller thread.
//
// It schedules host-side work (data-pipeline stages, checkpoint IO);
// torch's streams order the device's.
#ifndef MXNET_TPU_ENGINE_H_
#define MXNET_TPU_ENGINE_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace mxnet_tpu {

class Engine;

struct EngineVar {
  std::mutex mu;
  uint64_t version = 0;
  int active_reads = 0;
  bool active_write = false;
  struct Waiter { struct Opr* op; bool is_write; };
  std::deque<Waiter> queue;
  std::shared_ptr<std::string> exception;  // deferred error, set by a failed op
};

struct Opr {
  std::function<int(std::string*)> fn;  // returns nonzero on error
  std::vector<EngineVar*> const_vars, mutate_vars;
  int priority = 0;
  uint64_t seq = 0;  // FIFO tiebreak
  std::string name;
  bool always_run = false;  // run fn even when an input carries an exception
                            // (sync/wait ops must always signal)
  bool sync_op = false;     // WaitForVar's sync writer: serializes behind
                            // everything already pushed on the var but is
                            // not a real write — no version bump, no
                            // exception propagation (its fn consumes the
                            // var's deferred error itself)
  EngineVar* delete_target = nullptr;  // var freed after this op completes
  std::atomic<int> wait{0};
};

class Engine {
 public:
  // num_workers <= 0 → hardware_concurrency; naive=true → synchronous.
  explicit Engine(int num_workers = 0, bool naive = false);
  ~Engine();

  EngineVar* NewVar();
  // Deletes when all pending ops on the var complete (reference:
  // Engine::DeleteVariable pushes a deletion op).
  void DeleteVar(EngineVar* var);

  void PushAsync(std::function<int(std::string*)> fn,
                 std::vector<EngineVar*> const_vars,
                 std::vector<EngineVar*> mutate_vars,
                 int priority = 0, const char* name = "",
                 bool always_run = false, bool sync_op = false);

  // Returns empty string on success, else the deferred error (cleared).
  std::string WaitForVar(EngineVar* var);
  std::string WaitForAll();

  bool naive() const { return naive_; }

  // Monotonic engine telemetry (MXEngineStats): counts
  // are relaxed atomics bumped on the dispatch/execute paths — the
  // cost is one uncontended atomic add per op, cheap enough to stay
  // always-on.  queue_depth snapshots ready_.size() under pool_mu_
  // (instantaneous, not monotonic); outstanding is the in-flight op
  // count WaitForAll blocks on.
  struct Stats {
    uint64_t ops_dispatched;   // PushAsync calls (incl. naive + deletes)
    uint64_t ops_executed;     // op fns completed (naive: == dispatched)
    uint64_t worker_wakeups;   // WorkerLoop cv wakeups that found work
    uint64_t queue_depth;      // ready ops not yet claimed by a worker
    uint64_t outstanding;      // pushed, not yet completed
    uint64_t workers;          // worker-thread count (0 under naive)
  };
  Stats GetStats();

 private:
  void Schedule(Opr* op);
  void Dispatch(Opr* op);
  void Execute(Opr* op);
  void OnComplete(Opr* op, const std::string& err, bool own_failure);
  void ProcessQueue(EngineVar* var);  // var->mu must be held
  void DecWait(Opr* op);
  void WorkerLoop();

  struct Cmp {
    bool operator()(Opr* a, Opr* b) const {
      if (a->priority != b->priority) return a->priority < b->priority;
      return a->seq > b->seq;  // lower seq first
    }
  };

  bool naive_;
  // Serializes the Schedule() registration scan.  Registration of one
  // op across its var set must be atomic w.r.t. other registrations:
  // without it, two threads pushing ops with opposite (const, mutate)
  // var orders can interleave their queue appends and form a wait
  // cycle (A queued behind B on v2 while B is queued behind A on v1 —
  // found by the `make tsan` stress harness, mode `dispatch`).  With
  // the scan serialized, "X waits on Y" implies Y registered first,
  // so waits-for is acyclic.  Execution is untouched — this is one
  // uncontended mutex per push, on the dispatch path only.
  std::mutex sched_mu_;
  std::atomic<bool> stop_{false};
  std::atomic<uint64_t> seq_{0};
  std::atomic<uint64_t> stat_dispatched_{0};
  std::atomic<uint64_t> stat_executed_{0};
  std::atomic<uint64_t> stat_wakeups_{0};
  std::atomic<int64_t> outstanding_{0};
  std::mutex pool_mu_;
  std::condition_variable pool_cv_, all_done_cv_;
  std::priority_queue<Opr*, std::vector<Opr*>, Cmp> ready_;
  std::vector<std::thread> workers_;
  std::mutex err_mu_;
  std::string global_err_;
};

}  // namespace mxnet_tpu

#endif  // MXNET_TPU_ENGINE_H_
