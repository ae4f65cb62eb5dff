// See engine.h for design notes.
#include "engine.h"

#include <algorithm>
#include <cassert>

namespace mxnet_tpu {

Engine::Engine(int num_workers, bool naive) : naive_(naive) {
  if (naive_) return;
  int n = num_workers > 0 ? num_workers
                          : static_cast<int>(std::thread::hardware_concurrency());
  if (n <= 0) n = 4;
  for (int i = 0; i < n; ++i)
    workers_.emplace_back(&Engine::WorkerLoop, this);
}

Engine::~Engine() {
  WaitForAll();
  {
    // The predicate store must happen under pool_mu_: a worker that
    // just evaluated the wait predicate false still holds the mutex
    // until it blocks, so a store+notify landing in that window is
    // lost and join() deadlocks (missed wakeup).  Locking orders the
    // store against every predicate evaluation.
    std::lock_guard<std::mutex> lk(pool_mu_);
    stop_.store(true);
  }
  pool_cv_.notify_all();
  for (auto& w : workers_) w.join();
}

EngineVar* Engine::NewVar() { return new EngineVar(); }

void Engine::DeleteVar(EngineVar* var) {
  // A write op serialized behind every already-pushed op on the var; the
  // var is freed after the op completes (reference: Engine::DeleteVariable).
  // Contract: the caller must not push further ops on the var.
  if (naive_) { delete var; return; }
  Opr* op = new Opr();
  op->fn = [](std::string*) { return 0; };
  op->mutate_vars = {var};
  op->seq = seq_.fetch_add(1);
  op->name = "delete_var";
  op->always_run = true;
  op->delete_target = var;
  stat_dispatched_.fetch_add(1, std::memory_order_relaxed);
  outstanding_.fetch_add(1);
  Schedule(op);
}

void Engine::PushAsync(std::function<int(std::string*)> fn,
                       std::vector<EngineVar*> const_vars,
                       std::vector<EngineVar*> mutate_vars,
                       int priority, const char* name, bool always_run,
                       bool sync_op) {
  // dedup: a var both read and mutated counts as mutated only (reference:
  // ThreadedEngine deduplicates const/mutate overlap)
  std::sort(mutate_vars.begin(), mutate_vars.end());
  mutate_vars.erase(std::unique(mutate_vars.begin(), mutate_vars.end()),
                    mutate_vars.end());
  std::sort(const_vars.begin(), const_vars.end());
  const_vars.erase(std::unique(const_vars.begin(), const_vars.end()),
                   const_vars.end());
  std::vector<EngineVar*> pure_const;
  for (auto* v : const_vars)
    if (!std::binary_search(mutate_vars.begin(), mutate_vars.end(), v))
      pure_const.push_back(v);

  stat_dispatched_.fetch_add(1, std::memory_order_relaxed);
  if (naive_) {
    // synchronous: check input exceptions, run, store errors — same
    // observable semantics, zero async.  Var fields still need their
    // mutex: "synchronous" means in-caller-thread, not single-threaded
    // — concurrent Python threads push on a NaiveEngine (ctypes drops
    // the GIL), and unlocked version++/exception races corrupt both.
    stat_executed_.fetch_add(1, std::memory_order_relaxed);
    std::string first_err;
    for (auto* v : pure_const) {
      std::lock_guard<std::mutex> lk(v->mu);
      if (v->exception && first_err.empty()) first_err = *v->exception;
    }
    for (auto* v : mutate_vars) {
      std::lock_guard<std::mutex> lk(v->mu);
      if (v->exception && first_err.empty()) first_err = *v->exception;
    }
    std::string err;
    if (first_err.empty()) {
      if (fn(&err) != 0 && err.empty()) err = "operation failed";
    } else {
      err = first_err;
    }
    for (auto* v : mutate_vars) {
      std::lock_guard<std::mutex> lk(v->mu);
      v->version++;
      v->exception = err.empty() ? nullptr
                                 : std::make_shared<std::string>(err);
    }
    if (!err.empty() && first_err.empty()) {  // own failure only (above)
      std::lock_guard<std::mutex> lk(err_mu_);
      if (global_err_.empty()) global_err_ = err;
    }
    return;
  }

  Opr* op = new Opr();
  op->fn = std::move(fn);
  op->const_vars = std::move(pure_const);
  op->mutate_vars = std::move(mutate_vars);
  op->priority = priority;
  op->seq = seq_.fetch_add(1);
  op->name = name;
  op->always_run = always_run;
  op->sync_op = sync_op;
  outstanding_.fetch_add(1);
  Schedule(op);
}

void Engine::Schedule(Opr* op) {
  // sched_mu_ makes the whole var-set registration atomic w.r.t. other
  // pushes (see engine.h) — per-var queue order then agrees with one
  // global registration order and the waits-for graph cannot cycle.
  std::lock_guard<std::mutex> reg(sched_mu_);
  int total = static_cast<int>(op->const_vars.size() + op->mutate_vars.size());
  op->wait.store(total + 1);  // +1 guard: avoid dispatch before scan finishes
  int satisfied = 0;
  for (auto* v : op->const_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    if (!v->active_write && v->queue.empty()) {
      v->active_reads++;
      satisfied++;
    } else {
      v->queue.push_back({op, false});
    }
  }
  for (auto* v : op->mutate_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    if (!v->active_write && v->active_reads == 0 && v->queue.empty()) {
      v->active_write = true;
      satisfied++;
    } else {
      v->queue.push_back({op, true});
    }
  }
  // release guard + all satisfied deps at once
  if (op->wait.fetch_sub(satisfied + 1) == satisfied + 1) Dispatch(op);
}

void Engine::DecWait(Opr* op) {
  if (op->wait.fetch_sub(1) == 1) Dispatch(op);
}

void Engine::Dispatch(Opr* op) {
  std::lock_guard<std::mutex> lk(pool_mu_);
  ready_.push(op);
  pool_cv_.notify_one();
}

void Engine::WorkerLoop() {
  while (true) {
    Opr* op = nullptr;
    {
      std::unique_lock<std::mutex> lk(pool_mu_);
      pool_cv_.wait(lk, [&] { return stop_.load() || !ready_.empty(); });
      if (stop_.load() && ready_.empty()) return;
      stat_wakeups_.fetch_add(1, std::memory_order_relaxed);
      op = ready_.top();
      ready_.pop();
    }
    Execute(op);
  }
}

void Engine::Execute(Opr* op) {
  stat_executed_.fetch_add(1, std::memory_order_relaxed);
  // propagate input exceptions without running (reference: dependent ops
  // of a failed op are skipped, error flows to their outputs).  A sync_op
  // (WaitForVar's serialized waiter) consumes the var's deferred error in
  // its own fn and must not re-propagate it.
  std::string input_err;
  if (!op->sync_op) {
    for (auto* v : op->const_vars) {
      std::lock_guard<std::mutex> lk(v->mu);
      if (v->exception) { input_err = *v->exception; break; }
    }
    if (input_err.empty()) {
      for (auto* v : op->mutate_vars) {
        std::lock_guard<std::mutex> lk(v->mu);
        if (v->exception) { input_err = *v->exception; break; }
      }
    }
  }
  std::string err;
  if (input_err.empty() || op->always_run) {
    try {
      if (op->fn(&err) != 0 && err.empty()) err = "operation failed";
    } catch (const std::exception& e) {
      err = e.what();
    }
    if (!input_err.empty()) err = input_err;  // still propagate
  } else {
    err = input_err;
  }
  // Only an op that failed ITSELF records the global error.  A skipped
  // dependent (or an always_run helper like wait_for_var's sync op)
  // propagates the error to its output vars but must not re-populate
  // global_err_ — WaitForVar clears the global entry on rethrow, and a
  // propagating op completing after that clear would resurrect a
  // stale error into the next WaitForAll.
  OnComplete(op, err, /*own_failure=*/input_err.empty() && !err.empty());
}

void Engine::OnComplete(Opr* op, const std::string& err, bool own_failure) {
  auto exc = err.empty() ? nullptr : std::make_shared<std::string>(err);
  for (auto* v : op->const_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->active_reads--;
    ProcessQueue(v);
  }
  for (auto* v : op->mutate_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->active_write = false;
    if (!op->sync_op) {        // a sync waiter is not a real write:
      v->version++;            // no version bump, no error write-back
      if (exc) v->exception = exc;
    }
    ProcessQueue(v);
  }
  if (own_failure) {
    std::lock_guard<std::mutex> lk(err_mu_);
    if (global_err_.empty()) global_err_ = err;
  }
  if (op->delete_target) delete op->delete_target;
  delete op;
  if (outstanding_.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lk(pool_mu_);
    all_done_cv_.notify_all();
  }
}

// mxlint: requires(EngineVar::mu) -- caller holds v->mu (documented
// precondition, see engine.h)
void Engine::ProcessQueue(EngineVar* v) {
  while (!v->queue.empty()) {
    auto& head = v->queue.front();
    if (head.is_write) {
      if (v->active_reads == 0 && !v->active_write) {
        v->active_write = true;
        Opr* op = head.op;
        v->queue.pop_front();
        DecWait(op);
      }
      break;
    }
    if (v->active_write) break;
    v->active_reads++;
    Opr* op = head.op;
    v->queue.pop_front();
    DecWait(op);
  }
}

std::string Engine::WaitForVar(EngineVar* var) {
  if (naive_) {
    std::string e;
    {
      std::lock_guard<std::mutex> vlk(var->mu);
      if (var->exception) {
        e = *var->exception;
        var->exception = nullptr;  // rethrow-once semantics
      }
    }
    if (e.empty()) return "";
    std::lock_guard<std::mutex> lk(err_mu_);
    if (global_err_ == e) global_err_.clear();
    return e;
  }
  // The waiter is pushed as a WRITE (sync_op): it dispatches only after
  // every op pushed before this call has completed — including dependent
  // readers that must observe the var's exception and be skipped.  The
  // old read-op waiter raced them: its high priority let it run (and
  // clear the exception, rethrow-once) before an already-queued
  // dependent executed, so the dependent saw a clean var and ran.
  // Consuming + clearing inside the fn keeps the rethrow-once clear
  // ordered with the var's dependency stream; sync_op suppresses the
  // version bump and error write-back a real write would do.
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  std::string var_err;
  PushAsync(
      [&](std::string*) {
        {
          std::lock_guard<std::mutex> vlk(var->mu);
          if (var->exception) {
            var_err = *var->exception;
            var->exception = nullptr;  // rethrow-once semantics
          }
        }
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv.notify_all();
        return 0;
      },
      {}, {var}, /*priority=*/1 << 20, "wait_for_var",
      /*always_run=*/true, /*sync_op=*/true);
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done; });
  if (!var_err.empty()) {
    // Clear the global error only if it is THIS error; a different failed
    // op's deferred error must still surface at WaitForAll.
    std::lock_guard<std::mutex> elk(err_mu_);
    if (global_err_ == var_err) global_err_.clear();
  }
  return var_err;
}

Engine::Stats Engine::GetStats() {
  Stats s;
  s.ops_dispatched = stat_dispatched_.load(std::memory_order_relaxed);
  s.ops_executed = stat_executed_.load(std::memory_order_relaxed);
  s.worker_wakeups = stat_wakeups_.load(std::memory_order_relaxed);
  s.workers = static_cast<uint64_t>(workers_.size());
  int64_t out = outstanding_.load();
  s.outstanding = out > 0 ? static_cast<uint64_t>(out) : 0;
  {
    std::lock_guard<std::mutex> lk(pool_mu_);
    s.queue_depth = static_cast<uint64_t>(ready_.size());
  }
  return s;
}

std::string Engine::WaitForAll() {
  if (!naive_) {
    std::unique_lock<std::mutex> lk(pool_mu_);
    all_done_cv_.wait(lk, [&] { return outstanding_.load() == 0; });
  }
  std::lock_guard<std::mutex> lk(err_mu_);
  std::string e = global_err_;
  global_err_.clear();
  return e;
}

}  // namespace mxnet_tpu
