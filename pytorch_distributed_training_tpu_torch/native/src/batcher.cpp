// Native prefetching batch assembler for the port's data pipeline.
//
// A worker pool gathers permuted dataset rows into a ring of reusable slots
// while the card runs the previous step, so host assembly overlaps device
// work (the Python ShardedLoader, data/pipeline.py, assembles on the
// calling thread).
//
// Contract with the Python wrapper (data/native_loader.py, via ctypes):
// - The dataset stays owned by Python (numpy int32 arrays); this library
//   keeps raw pointers, so the wrapper must keep the arrays alive.
// - The epoch permutation is SUPPLIED by the wrapper (numpy
//   default_rng((seed, epoch)).permutation, the exact order the Python
//   ShardedLoader uses), so the two engines are interchangeable mid-run
//   (mid-epoch resume skips the same batches either way) and every rank
//   assembles its slice of the same global batch (divergent orders would
//   deadlock the collectives).
// - Slots are returned in step order; a slot's buffers stay valid until
//   batcher_release(slot). The wrapper releases slot s when it has moved
//   on to slot s+2, once the copy that read the slot has completed.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<std::vector<int32_t>> buffers;  // one per dataset array
  std::atomic<int64_t> ready_step{-1};        // which step this slot holds
  std::atomic<bool> in_use{false};            // held by the consumer
};

struct Batcher {
  // dataset
  std::vector<const int32_t*> arrays;
  std::vector<int64_t> row_elems;  // elements per row, per array
  int64_t n_rows = 0;

  // batch geometry (per host)
  int64_t accum = 1;
  int64_t micro_global = 0;  // global micro-batch rows
  int64_t micro_local = 0;   // this host's rows per microbatch
  int64_t local_off = 0;     // this host's row offset inside a microbatch

  // epoch state
  std::vector<int64_t> perm;
  int64_t n_steps = 0;
  std::atomic<int64_t> next_claim{0};   // producer work queue
  std::atomic<int64_t> consumed{0};     // consumer cursor
  uint64_t epoch_gen = 0;               // bumped per start_epoch
  int64_t fills_in_flight = 0;          // workers currently inside fill()
  std::condition_variable cv_quiesce;   // start_epoch waits for 0

  // ring
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;  // consumer waits for its step
  std::condition_variable cv_free;   // producers wait for a free slot

  // workers
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void fill(int64_t step, Slot& slot) {
    const int64_t gb = accum * micro_global;
    for (size_t a = 0; a < arrays.size(); ++a) {
      const int64_t re = row_elems[a];
      int32_t* dst = slot.buffers[a].data();
      for (int64_t m = 0; m < accum; ++m) {
        const int64_t* idx =
            perm.data() + step * gb + m * micro_global + local_off;
        for (int64_t r = 0; r < micro_local; ++r) {
          std::memcpy(dst, arrays[a] + idx[r] * re,
                      static_cast<size_t>(re) * sizeof(int32_t));
          dst += re;
        }
      }
    }
  }

  void worker_loop() {
    while (!stop.load(std::memory_order_acquire)) {
      int64_t step;
      uint64_t gen;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          if (stop.load(std::memory_order_relaxed)) return true;
          int64_t s = next_claim.load(std::memory_order_relaxed);
          if (s >= n_steps) return false;  // epoch drained; wait for next
          // never run more than one ring ahead of the consumer: claiming
          // step s reuses the slot that held step s - n_slots, so s must
          // wait until that batch has been handed out (consumed) AND its
          // slot released — otherwise the producer overwrites a pending
          // batch and the consumer waits forever for its ready_step.
          if (s >= consumed.load(std::memory_order_acquire) +
                       static_cast<int64_t>(slots.size()))
            return false;
          Slot& sl = slots[s % slots.size()];
          return !sl.in_use.load(std::memory_order_acquire) &&
                 sl.ready_step.load(std::memory_order_acquire) < s;
        });
        if (stop.load(std::memory_order_relaxed)) return;
        step = next_claim.fetch_add(1, std::memory_order_relaxed);
        gen = epoch_gen;
        if (step >= n_steps) continue;  // raced past the end
        slots[step % slots.size()].in_use.store(true,
                                                std::memory_order_release);
        ++fills_in_flight;
      }
      Slot& sl = slots[step % slots.size()];
      fill(step, sl);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (gen == epoch_gen) {
          sl.ready_step.store(step, std::memory_order_release);
          cv_ready.notify_all();
        }
        // stale (superseded-epoch) fills publish nothing, but ALWAYS give
        // the slot back — start_epoch has quiesced, so no new-epoch worker
        // can have touched it concurrently
        sl.in_use.store(false, std::memory_order_release);
        if (--fills_in_flight == 0) cv_quiesce.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

Batcher* batcher_create(const int32_t** arrays, const int64_t* row_elems,
                        int32_t n_arrays, int64_t n_rows, int64_t accum,
                        int64_t micro_global, int64_t micro_local,
                        int64_t local_off, int32_t n_slots,
                        int32_t n_threads) {
  auto* b = new Batcher();
  for (int32_t i = 0; i < n_arrays; ++i) {
    b->arrays.push_back(arrays[i]);
    b->row_elems.push_back(row_elems[i]);
  }
  b->n_rows = n_rows;
  b->accum = accum;
  b->micro_global = micro_global;
  b->micro_local = micro_local;
  b->local_off = local_off;
  b->slots = std::vector<Slot>(static_cast<size_t>(n_slots));
  for (auto& s : b->slots) {
    s.buffers.resize(b->arrays.size());
    for (size_t a = 0; a < b->arrays.size(); ++a) {
      s.buffers[a].resize(
          static_cast<size_t>(accum * micro_local * b->row_elems[a]));
    }
  }
  for (int32_t t = 0; t < n_threads; ++t) {
    b->workers.emplace_back([b] { b->worker_loop(); });
  }
  return b;
}

// Begin an epoch over the supplied row permutation (length n_rows, from
// the wrapper — identical to the Python loader's order). Returns the number
// of steps in the epoch.
int64_t batcher_start_epoch(Batcher* b, const int64_t* perm) {
  std::unique_lock<std::mutex> lk(b->mu);
  // Supersede the old epoch FIRST so in-flight fills discard their result,
  // then quiesce: fill() reads b->perm and writes slot buffers, so both the
  // perm.assign below and new-epoch fills must not overlap a stale fill
  // (an abandoned epoch's generator leaves workers mid-fill).
  b->epoch_gen++;
  b->next_claim.store(b->n_steps, std::memory_order_release);  // no new claims
  b->cv_quiesce.wait(lk, [&] { return b->fills_in_flight == 0; });
  b->perm.assign(perm, perm + b->n_rows);
  const int64_t gb = b->accum * b->micro_global;
  b->n_steps = b->n_rows / gb;  // drop ragged tail (train semantics)
  b->next_claim.store(0, std::memory_order_release);
  b->consumed.store(0, std::memory_order_release);
  for (auto& s : b->slots) {
    s.ready_step.store(-1, std::memory_order_release);
    s.in_use.store(false, std::memory_order_release);
  }
  b->cv_free.notify_all();
  return b->n_steps;
}

// Blocks until the next in-order batch is assembled. Writes one pointer per
// dataset array into out_ptrs. Returns the slot id, or -1 at end of epoch.
int32_t batcher_next(Batcher* b, int32_t** out_ptrs) {
  int64_t step;
  Slot* sl;
  {
    std::unique_lock<std::mutex> lk(b->mu);
    step = b->consumed.load(std::memory_order_acquire);
    if (step >= b->n_steps) return -1;
    sl = &b->slots[step % b->slots.size()];
    b->cv_ready.wait(lk, [&] {
      return sl->ready_step.load(std::memory_order_acquire) == step;
    });
    sl->in_use.store(true, std::memory_order_release);  // held by consumer
    // advance under the lock so producers' claim-gate predicate never
    // misses the wakeup below
    b->consumed.store(step + 1, std::memory_order_release);
  }
  b->cv_free.notify_all();
  for (size_t a = 0; a < sl->buffers.size(); ++a) {
    out_ptrs[a] = sl->buffers[a].data();
  }
  return static_cast<int32_t>(step % b->slots.size());
}

// The consumer is done with this slot's buffers; producers may reuse it.
void batcher_release(Batcher* b, int32_t slot) {
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->slots[static_cast<size_t>(slot)].in_use.store(
        false, std::memory_order_release);
  }
  b->cv_free.notify_all();
}

void batcher_destroy(Batcher* b) {
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->stop.store(true, std::memory_order_release);
  }
  b->cv_free.notify_all();
  b->cv_ready.notify_all();
  for (auto& t : b->workers) t.join();
  delete b;
}

}  // extern "C"
