// Asynchronous file I/O engines for NVMe tensor swapping (ZeRO-Infinity).
//
// The PyTorch port's copy of the JAX package's csrc/aio/host_aio.cpp, the
// counterpart of the reference's csrc/aio/ stack
// (deepspeed_aio_common.cpp + py_lib/deepspeed_py_aio_handle.cpp:282
// `aio_handle` with a worker-thread pool, O_DIRECT block transfers, and
// queue_depth in-flight requests).  The reference rides libaio; this file
// holds the two portable engines behind the ds_aio::AioEngine interface
// (aio_backend.h):
//
//   threadpool — pthread worker pool, one positional pread/pwrite syscall
//                per block_size chunk (the original engine).
//   batched    — same pool, but each worker drains up to queue_depth
//                chunks per lock acquisition and submits contiguous runs
//                as ONE preadv/pwritev call (one syscall per submission
//                queue of block_size segments instead of one per
//                segment).  This is the submission batching the libaio /
//                io_uring machinery provides, rebuilt on portable
//                positional I/O — the fallback tier when uring_aio.cpp's
//                runtime probe fails (pre-5.1 kernels, seccomp).
//
// C ABI (consumed by deepspeed_tpu_torch/runtime/swap_tensor/aio_handle.py):
//   ds_aio_create(block_size, queue_depth, single_submit, overlap_events,
//                 thread_count) -> handle           [threadpool, legacy]
//   ds_aio_create2(..., backend) -> handle | NULL   [0=pool 1=batched
//                                                    2=io_uring]
//   ds_aio_backend(handle) -> backend id actually running
//   ds_aio_pread / ds_aio_pwrite(handle, buf, n, path, async) -> 0 | -errno
//   ds_aio_wait(handle) -> completed ops | <0 first error
//   ds_aio_destroy(handle)
//   ds_uring_probe() -> 1 if io_uring works here   [uring_aio.cpp]

#include <errno.h>
#include <fcntl.h>
#include <limits.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "aio_backend.h"

namespace {

using ds_aio::AioEngine;

// One chunk of a request, executed by a worker.  Requests are split into
// block_size chunks so a single large tensor fans out over the whole pool
// (the reference's deepspeed_aio_utils.cpp slicing).
struct Chunk {
  bool is_read;
  char* buffer;
  int64_t offset;
  int64_t num_bytes;
  int fd;
  std::atomic<int>* pending;   // per-request chunk counter
  std::atomic<int>* fd_refs;   // close fd when it hits zero
};

// Transfer a contiguous run of segments (contiguous in memory AND file —
// request chunks are sliced that way) with one vectored syscall, finishing
// any partial completion with plain positional I/O on the remainder.
int TransferRun(bool is_read, int fd, const std::vector<Chunk>& run) {
  if (run.empty()) return 0;
  std::vector<struct iovec> iov;
  iov.reserve(run.size());
  int64_t total = 0;
  for (const Chunk& ch : run) {
    if (ch.num_bytes <= 0) continue;
    iov.push_back({ch.buffer, static_cast<size_t>(ch.num_bytes)});
    total += ch.num_bytes;
  }
  if (total == 0) return 0;
  char* base = run.front().buffer;
  int64_t off = run.front().offset;
  ssize_t n = is_read
                  ? preadv(fd, iov.data(), static_cast<int>(iov.size()), off)
                  : pwritev(fd, iov.data(), static_cast<int>(iov.size()),
                            off);
  if (n < 0) return -errno;
  int64_t done = n;
  while (done < total) {  // partial vectored completion: finish flat
    ssize_t m = is_read ? pread(fd, base + done, total - done, off + done)
                        : pwrite(fd, base + done, total - done, off + done);
    if (m < 0) return -errno;
    if (m == 0) return -EIO;  // short file on read / wedged write
    done += m;
  }
  return 0;
}

// Worker-pool engine.  batched=false: one syscall per chunk (the original
// threadpool).  batched=true: each worker drains up to queue_depth queued
// chunks per lock acquisition and coalesces contiguous runs into single
// preadv/pwritev submissions.
class PoolEngine : public AioEngine {
 public:
  PoolEngine(int64_t block_size, int queue_depth, int thread_count,
             bool batched, bool single_submit)
      : block_size_(block_size < 4096 ? 4096 : block_size),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth),
        // single_submit mirrors the reference knob: submit each segment
        // individually instead of a batch per drain
        batch_limit_(batched && !single_submit
                         ? (queue_depth_ > IOV_MAX ? IOV_MAX : queue_depth_)
                         : 1),
        batched_(batched),
        stop_(false), inflight_(0), first_error_(0) {
    int n = thread_count < 1 ? 1 : thread_count;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~PoolEngine() override {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();  // workers drain the queue first,
                                        // freeing every counter en route
  }

  int backend() const override {
    return batched_ ? ds_aio::kBatched : ds_aio::kThreadPool;
  }

  int Submit(bool is_read, char* buffer, int64_t num_bytes,
             const char* path) override {
    int flags = is_read ? O_RDONLY : (O_WRONLY | O_CREAT | O_TRUNC);
    int fd = open(path, flags, 0644);
    if (fd < 0) return -errno;

    int64_t nchunks = (num_bytes + block_size_ - 1) / block_size_;
    if (nchunks == 0) nchunks = 1;
    // Freed by whichever worker performs the LAST decrement (fetch_sub
    // returning 1 — nobody touches the counter after that), so a
    // long-lived handle does not grow memory with every swap request.
    auto* pending = new std::atomic<int>(static_cast<int>(nchunks));
    auto* fd_refs = new std::atomic<int>(static_cast<int>(nchunks));
    {
      std::unique_lock<std::mutex> lk(mu_);
      // Respect queue_depth: block submission while too many chunks queued
      // (the reference bounds in-flight iocbs the same way).
      submit_cv_.wait(lk, [this] {
        return inflight_ < queue_depth_ * 64 || stop_;
      });
      for (int64_t c = 0; c < nchunks; ++c) {
        int64_t off = c * block_size_;
        int64_t len = num_bytes - off;
        if (len > block_size_) len = block_size_;
        if (len < 0) len = 0;
        queue_.push_back(Chunk{is_read, buffer + off, off, len, fd,
                               pending, fd_refs});
        ++inflight_;
      }
    }
    cv_.notify_all();
    return 0;
  }

  // Wait for all submitted requests; returns completed request count or
  // negative errno of the first failure.
  int Wait() override {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return inflight_ == 0; });
    int rc = first_error_.exchange(0);  // clear: one failed batch must not
                                        // poison every later Wait()
    int completed = completed_requests_;
    completed_requests_ = 0;
    return rc != 0 ? rc : completed;
  }

 private:
  void WorkerLoop() {
    std::vector<Chunk> batch;
    for (;;) {
      batch.clear();
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        // Drain up to batch_limit_ chunks in ONE lock acquisition — the
        // submission batch.  batch_limit_==1 is the original threadpool.
        while (!queue_.empty() &&
               batch.size() < static_cast<size_t>(batch_limit_)) {
          batch.push_back(queue_.front());
          queue_.pop_front();
        }
      }
      size_t i = 0;
      while (i < batch.size()) {
        // Coalesce the contiguous run starting at i (same fd + adjacent
        // memory and file spans — chunks of one request in order).
        size_t j = i + 1;
        while (j < batch.size() && batch[j].fd == batch[i].fd &&
               batch[j].is_read == batch[i].is_read &&
               batch[j].buffer ==
                   batch[j - 1].buffer + batch[j - 1].num_bytes &&
               batch[j].offset ==
                   batch[j - 1].offset + batch[j - 1].num_bytes) {
          ++j;
        }
        std::vector<Chunk> run(batch.begin() + i, batch.begin() + j);
        int err = TransferRun(batch[i].is_read, batch[i].fd, run);
        if (err != 0) {
          int expected = 0;
          first_error_.compare_exchange_strong(expected, err);
        }
        RetireChunks(run);
        i = j;
      }
    }
  }

  void RetireChunks(const std::vector<Chunk>& run) {
    int requests_done = 0;
    for (const Chunk& ch : run) {
      if (ch.fd_refs->fetch_sub(1) == 1) {
        close(ch.fd);
        delete ch.fd_refs;
      }
      if (ch.pending->fetch_sub(1) == 1) {
        ++requests_done;
        delete ch.pending;
      }
    }
    {
      std::unique_lock<std::mutex> lk(mu_);
      inflight_ -= static_cast<int64_t>(run.size());
      completed_requests_ += requests_done;
      if (inflight_ == 0) done_cv_.notify_all();
      submit_cv_.notify_all();
    }
  }

  int64_t block_size_;
  int queue_depth_;
  int batch_limit_;
  bool batched_;
  bool stop_;
  int64_t inflight_;
  int completed_requests_ = 0;
  std::atomic<int> first_error_;
  std::deque<Chunk> queue_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_, submit_cv_;
};

struct HandleBox {
  AioEngine* engine;
  int64_t block_size;
  int queue_depth;
};

}  // namespace

extern "C" {

void* ds_aio_create2(int64_t block_size, int queue_depth, int single_submit,
                     int overlap_events, int thread_count, int backend) {
  (void)overlap_events;  // completions always overlap (workers / CQ ring)
  AioEngine* engine = nullptr;
  switch (backend) {
    case ds_aio::kThreadPool:
      engine = new PoolEngine(block_size, queue_depth, thread_count,
                              /*batched=*/false, single_submit != 0);
      break;
    case ds_aio::kBatched:
      engine = new PoolEngine(block_size, queue_depth, thread_count,
                              /*batched=*/true, single_submit != 0);
      break;
    case ds_aio::kIoUring:
      engine = ds_aio::CreateUringEngine(block_size, queue_depth,
                                         single_submit);
      break;
    default:
      return nullptr;
  }
  if (engine == nullptr) return nullptr;  // backend unavailable here
  return new HandleBox{engine, block_size < 4096 ? 4096 : block_size,
                       queue_depth < 1 ? 1 : queue_depth};
}

void* ds_aio_create(int64_t block_size, int queue_depth, int single_submit,
                    int overlap_events, int thread_count) {
  return ds_aio_create2(block_size, queue_depth, single_submit,
                        overlap_events, thread_count, ds_aio::kThreadPool);
}

void ds_aio_destroy(void* h) {
  auto* box = static_cast<HandleBox*>(h);
  delete box->engine;
  delete box;
}

int ds_aio_backend(void* h) {
  return static_cast<HandleBox*>(h)->engine->backend();
}

int ds_aio_pread(void* h, void* buffer, int64_t num_bytes, const char* path,
                 int async_op) {
  auto* box = static_cast<HandleBox*>(h);
  int rc = box->engine->Submit(true, static_cast<char*>(buffer), num_bytes,
                               path);
  if (rc != 0) return rc;
  if (!async_op) {
    int w = box->engine->Wait();
    return w < 0 ? w : 0;
  }
  return 0;
}

int ds_aio_pwrite(void* h, const void* buffer, int64_t num_bytes,
                  const char* path, int async_op) {
  auto* box = static_cast<HandleBox*>(h);
  int rc = box->engine->Submit(
      false, const_cast<char*>(static_cast<const char*>(buffer)), num_bytes,
      path);
  if (rc != 0) return rc;
  if (!async_op) {
    int w = box->engine->Wait();
    return w < 0 ? w : 0;
  }
  return 0;
}

int ds_aio_wait(void* h) { return static_cast<HandleBox*>(h)->engine->Wait(); }

int64_t ds_aio_block_size(void* h) {
  return static_cast<HandleBox*>(h)->block_size;
}

int ds_aio_queue_depth(void* h) {
  return static_cast<HandleBox*>(h)->queue_depth;
}

}  // extern "C"
