// Waitable MPMC batch queue — the admission primitive of the
// continuous-batching engine.
//
// The serving engine's loop needs "block until at least one request,
// then greedily drain up to max_n without oversleeping" semantics.
// Doing that over Python's queue.Queue costs a GIL round-trip per item
// per wake; this condition-variable queue is called once per batch via
// ctypes (GIL released while blocked, so producers run while the
// engine thread waits — and the bench/engine hot loop never sleeps in
// Python).
//
// Items are opaque uint64 handles (the Python side keeps id -> request).
//
// C ABI:
//   bq_create(capacity) -> handle
//   bq_push(handle, item) -> 0 | -1 full | -2 closed
//   bq_pop_batch(handle, out, max_n, first_wait_us, drain_wait_us)
//       -> n >= 0 (0 = timed out empty) | -2 closed-and-drained
//   bq_size(handle), bq_close(handle), bq_destroy(handle)

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>

namespace {

struct BatchQueue {
    std::mutex mu;
    std::condition_variable not_empty;
    std::condition_variable not_full;
    std::condition_variable drained;  // destroy handshake
    std::deque<uint64_t> items;
    size_t capacity;
    int waiters = 0;  // threads inside a blocking wait
    bool closed = false;

    explicit BatchQueue(size_t cap) : capacity(cap) {}
};

struct WaiterGuard {
    BatchQueue* q;  // mu must be held at construction and destruction
    explicit WaiterGuard(BatchQueue* queue) : q(queue) { q->waiters++; }
    ~WaiterGuard() {
        if (--q->waiters == 0) q->drained.notify_all();
    }
};

}  // namespace

extern "C" {

void* bq_create(long capacity) {
    return new BatchQueue(capacity > 0 ? static_cast<size_t>(capacity)
                                       : SIZE_MAX);
}

int bq_push(void* h, uint64_t item) {
    auto* q = static_cast<BatchQueue*>(h);
    std::unique_lock<std::mutex> lock(q->mu);
    if (q->closed) return -2;
    if (q->items.size() >= q->capacity) return -1;
    q->items.push_back(item);
    lock.unlock();
    q->not_empty.notify_one();
    return 0;
}

long bq_pop_batch(void* h, uint64_t* out, long max_n, long first_wait_us,
                  long drain_wait_us) {
    auto* q = static_cast<BatchQueue*>(h);
    std::unique_lock<std::mutex> lock(q->mu);
    WaiterGuard guard(q);
    if (q->items.empty() && !q->closed) {
        q->not_empty.wait_for(lock, std::chrono::microseconds(first_wait_us),
                              [q] { return !q->items.empty() || q->closed; });
    }
    if (q->items.empty()) return q->closed ? -2 : 0;

    long n = 0;
    auto grab = [&] {
        while (n < max_n && !q->items.empty()) {
            out[n++] = q->items.front();
            q->items.pop_front();
        }
    };
    grab();
    // opportunistic drain: brief extra window to coalesce stragglers
    // into this device batch (continuous-batching flush deadline)
    while (n < max_n && drain_wait_us > 0 && !q->closed) {
        if (!q->not_empty.wait_for(lock,
                                   std::chrono::microseconds(drain_wait_us),
                                   [q] { return !q->items.empty() ||
                                                q->closed; }))
            break;
        grab();
    }
    // notify under the lock and let WaiterGuard destruct while it is
    // still held — an early unlock would decrement waiters/notify
    // drained unsynchronized, racing bq_destroy into use-after-free
    q->not_full.notify_all();
    return n;
}

long bq_size(void* h) {
    auto* q = static_cast<BatchQueue*>(h);
    std::lock_guard<std::mutex> lock(q->mu);
    return static_cast<long>(q->items.size());
}

void bq_close(void* h) {
    auto* q = static_cast<BatchQueue*>(h);
    {
        std::lock_guard<std::mutex> lock(q->mu);
        q->closed = true;
    }
    q->not_empty.notify_all();
    q->not_full.notify_all();
}

void bq_destroy(void* h) {
    auto* q = static_cast<BatchQueue*>(h);
    {
        // close, wake everyone, and wait for blocked poppers to leave
        // before freeing the mutex/cvs they are waiting on
        std::unique_lock<std::mutex> lock(q->mu);
        q->closed = true;
        q->not_empty.notify_all();
        q->not_full.notify_all();
        q->drained.wait(lock, [q] { return q->waiters == 0; });
    }
    delete q;
}

}  // extern "C"
