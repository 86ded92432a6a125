// io_uring AIO engine — kernel submission/completion rings, no liburing.
//
// The reference's libaio machinery (deepspeed_aio_common.cpp: iocbs built
// per block, io_submit in batches of queue_depth, io_getevents reaping in
// bulk) is what lets ZeRO-Infinity hit NVMe line rate; io_uring is the
// modern kernel interface with the same shape (arXiv:2104.07857 §6).  This
// engine mmaps the SQ/CQ rings directly via the raw syscalls so no liburing
// package is required at build time:
//
//   Submit(): slice the request into block_size segments, write one SQE
//             (IORING_OP_READV/WRITEV, one iovec) per segment, and submit
//             the whole batch with a single io_uring_enter — or one enter
//             per segment when single_submit, the reference's knob.
//   Wait():   io_uring_enter(GETEVENTS) + drain the CQ ring in bulk;
//             short completions are finished synchronously (rare path);
//             first -errno wins, fds close on their last segment.
//
// Availability is RUNTIME-probed (ds_uring_probe): io_uring_setup returns
// ENOSYS on pre-5.1 kernels and EPERM under seccomp policies that deny it.
// Callers (aio_handle.py) fall back — loudly — to the batched pool engine
// in host_aio.cpp when the probe fails, so this file compiling is never
// enough to claim the backend works on a host.

#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <vector>

#if defined(__linux__) && __has_include(<linux/io_uring.h>)
#include <linux/io_uring.h>
#define DS_HAVE_URING_ABI 1
#else
#define DS_HAVE_URING_ABI 0
#endif

#include "aio_backend.h"

// The syscall numbers are arch-unified (>=424 block); define them when the
// libc headers predate io_uring.
#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif

namespace ds_aio {

#if DS_HAVE_URING_ABI

namespace {

int sys_uring_setup(unsigned entries, struct io_uring_params* p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                    unsigned flags) {
  return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                  min_complete, flags, nullptr, 0));
}

struct RequestState {
  int fd;
  int chunks_left;  // close fd + request completed (and freed) when 0
};

struct SegState {
  bool in_use = false;
  bool is_read = false;
  char* buffer = nullptr;
  int64_t offset = 0;
  int64_t num_bytes = 0;
  struct iovec iov {};
  RequestState* req = nullptr;
};

class UringEngine : public AioEngine {
 public:
  static UringEngine* Create(int64_t block_size, int queue_depth,
                             bool single_submit) {
    UringEngine* e = new UringEngine(block_size, queue_depth, single_submit);
    if (!e->InitRing()) {
      delete e;
      return nullptr;
    }
    return e;
  }

  ~UringEngine() override {
    if (sq_ring_ptr_ != MAP_FAILED && sq_ring_ptr_ != nullptr)
      munmap(sq_ring_ptr_, sq_ring_sz_);
    if (!single_mmap_ && cq_ring_ptr_ != MAP_FAILED &&
        cq_ring_ptr_ != nullptr)
      munmap(cq_ring_ptr_, cq_ring_sz_);
    if (sqes_ != MAP_FAILED && sqes_ != nullptr)
      munmap(sqes_, sqe_sz_);
    if (ring_fd_ >= 0) close(ring_fd_);
    for (RequestState* r : live_requests_) delete r;
  }

  int backend() const override { return kIoUring; }

  int Submit(bool is_read, char* buffer, int64_t num_bytes,
             const char* path) override {
    std::lock_guard<std::mutex> lk(mu_);
    int flags = is_read ? O_RDONLY : (O_WRONLY | O_CREAT | O_TRUNC);
    int fd = open(path, flags, 0644);
    if (fd < 0) return -errno;

    int64_t nchunks = (num_bytes + block_size_ - 1) / block_size_;
    if (nchunks == 0) nchunks = 1;
    auto* req = new RequestState{fd, static_cast<int>(nchunks)};
    live_requests_.push_back(req);
    unsigned queued = 0;
    for (int64_t c = 0; c < nchunks; ++c) {
      int64_t off = c * block_size_;
      int64_t len = num_bytes - off;
      if (len > block_size_) len = block_size_;
      if (len < 0) len = 0;
      int slot = AcquireSlot();  // reaps completions when rings are full
      if (slot < 0) return slot;
      SegState& seg = segs_[slot];
      seg.in_use = true;
      seg.is_read = is_read;
      seg.buffer = buffer + off;
      seg.offset = off;
      seg.num_bytes = len;
      seg.iov = {seg.buffer, static_cast<size_t>(len)};
      seg.req = req;
      PushSqe(slot);
      ++queued;
      if (single_submit_) {
        int rc = Flush(queued);
        if (rc < 0) return rc;
        queued = 0;
      }
    }
    // ONE io_uring_enter submits the whole request's segment batch — the
    // submission batching the threadpool engine lacks.
    if (queued > 0) {
      int rc = Flush(queued);
      if (rc < 0) return rc;
    }
    return 0;
  }

  int Wait() override {
    std::lock_guard<std::mutex> lk(mu_);
    if (to_submit_ > 0) {  // defensive: nothing queued may stay unsubmitted
      int rc = Flush(to_submit_);
      if (rc < 0) {
        int expected = 0;
        first_error_.compare_exchange_strong(expected, rc);
      }
    }
    while (inflight_ > 0) {
      int rc = ReapSome(/*wait=*/true);
      if (rc < 0) {
        int expected = 0;
        first_error_.compare_exchange_strong(expected, rc);
        break;
      }
    }
    int rc = first_error_.exchange(0);
    int completed = completed_requests_;
    completed_requests_ = 0;
    return rc != 0 ? rc : completed;
  }

 private:
  UringEngine(int64_t block_size, int queue_depth, bool single_submit)
      : block_size_(block_size < 4096 ? 4096 : block_size),
        queue_depth_(queue_depth < 1 ? 1
                     : queue_depth > 1024 ? 1024
                                          : queue_depth),
        single_submit_(single_submit),
        first_error_(0) {}

  bool InitRing() {
    struct io_uring_params p;
    memset(&p, 0, sizeof(p));
    ring_fd_ = sys_uring_setup(static_cast<unsigned>(queue_depth_), &p);
    if (ring_fd_ < 0) return false;

    sq_entries_ = p.sq_entries;
    cq_entries_ = p.cq_entries;
    single_mmap_ = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;

    sq_ring_sz_ = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz_ = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
    if (single_mmap_ && cq_ring_sz_ > sq_ring_sz_) sq_ring_sz_ = cq_ring_sz_;

    sq_ring_ptr_ = mmap(nullptr, sq_ring_sz_, PROT_READ | PROT_WRITE,
                        MAP_SHARED | MAP_POPULATE, ring_fd_,
                        IORING_OFF_SQ_RING);
    if (sq_ring_ptr_ == MAP_FAILED) return false;
    cq_ring_ptr_ = single_mmap_
                       ? sq_ring_ptr_
                       : mmap(nullptr, cq_ring_sz_, PROT_READ | PROT_WRITE,
                              MAP_SHARED | MAP_POPULATE, ring_fd_,
                              IORING_OFF_CQ_RING);
    if (cq_ring_ptr_ == MAP_FAILED) return false;

    sqe_sz_ = p.sq_entries * sizeof(struct io_uring_sqe);
    sqes_ = static_cast<struct io_uring_sqe*>(
        mmap(nullptr, sqe_sz_, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, ring_fd_, IORING_OFF_SQES));
    if (sqes_ == MAP_FAILED) return false;

    char* sq = static_cast<char*>(sq_ring_ptr_);
    sq_head_ = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail_ = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask_ = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array_ = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    char* cq = static_cast<char*>(cq_ring_ptr_);
    cq_head_ = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail_ = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask_ = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes_ = reinterpret_cast<struct io_uring_cqe*>(cq + p.cq_off.cqes);

    segs_.resize(sq_entries_);
    free_slots_.reserve(sq_entries_);
    for (unsigned i = 0; i < sq_entries_; ++i)
      free_slots_.push_back(static_cast<int>(i));
    return true;
  }

  // A free SQE/segment slot; reaps completions (blocking) when none left.
  // Queued-but-unsubmitted SQEs are flushed first — without that, a
  // request larger than sq_entries * block_size would exhaust the slots
  // with nothing in flight and the reap loop would spin forever.
  int AcquireSlot() {
    while (free_slots_.empty()) {
      if (to_submit_ > 0) {
        int rc = Flush(to_submit_);
        if (rc < 0) return rc;
      }
      int rc = ReapSome(/*wait=*/true);
      if (rc < 0) return rc;
    }
    int slot = free_slots_.back();
    free_slots_.pop_back();
    return slot;
  }

  void PushSqe(int slot) {
    unsigned tail = __atomic_load_n(sq_tail_, __ATOMIC_RELAXED);
    unsigned idx = tail & *sq_mask_;
    struct io_uring_sqe* sqe = &sqes_[idx];
    memset(sqe, 0, sizeof(*sqe));
    SegState& seg = segs_[slot];
    sqe->opcode = seg.is_read ? IORING_OP_READV : IORING_OP_WRITEV;
    sqe->fd = seg.req->fd;
    sqe->addr = reinterpret_cast<uint64_t>(&seg.iov);
    sqe->len = 1;
    sqe->off = static_cast<uint64_t>(seg.offset);
    sqe->user_data = static_cast<uint64_t>(slot);
    sq_array_[idx] = idx;
    __atomic_store_n(sq_tail_, tail + 1, __ATOMIC_RELEASE);
    ++to_submit_;
  }

  // Submit `queued` SQEs with one enter.
  int Flush(unsigned queued) {
    (void)queued;
    while (to_submit_ > 0) {
      int rc = sys_uring_enter(ring_fd_, to_submit_, 0, 0);
      if (rc < 0) {
        if (errno == EINTR) continue;
        return -errno;
      }
      to_submit_ -= static_cast<unsigned>(rc);
      inflight_ += static_cast<unsigned>(rc);
    }
    return 0;
  }

  // Drain the CQ ring; optionally block for at least one completion.
  int ReapSome(bool wait) {
    unsigned head = __atomic_load_n(cq_head_, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(cq_tail_, __ATOMIC_ACQUIRE);
    if (head == tail && wait && inflight_ > 0) {
      int rc = sys_uring_enter(ring_fd_, 0, 1, IORING_ENTER_GETEVENTS);
      if (rc < 0 && errno != EINTR) return -errno;
      tail = __atomic_load_n(cq_tail_, __ATOMIC_ACQUIRE);
    }
    while (head != tail) {
      struct io_uring_cqe* cqe = &cqes_[head & *cq_mask_];
      CompleteSeg(static_cast<int>(cqe->user_data), cqe->res);
      ++head;
    }
    __atomic_store_n(cq_head_, head, __ATOMIC_RELEASE);
    return 0;
  }

  void CompleteSeg(int slot, int res) {
    SegState& seg = segs_[slot];
    if (!seg.in_use) return;  // defensive: unknown user_data
    int err = 0;
    if (res < 0) {
      err = res;
    } else if (res < seg.num_bytes) {
      // Short completion: finish the remainder synchronously (rare; the
      // segment span is contiguous so flat positional I/O completes it).
      int64_t done = res;
      while (done < seg.num_bytes) {
        ssize_t m = seg.is_read
                        ? pread(seg.req->fd, seg.buffer + done,
                                seg.num_bytes - done, seg.offset + done)
                        : pwrite(seg.req->fd, seg.buffer + done,
                                 seg.num_bytes - done, seg.offset + done);
        if (m < 0) {
          err = -errno;
          break;
        }
        if (m == 0) {
          err = -EIO;
          break;
        }
        done += m;
      }
    }
    if (err != 0) {
      int expected = 0;
      first_error_.compare_exchange_strong(expected, err);
    }
    RequestState* req = seg.req;
    seg.in_use = false;
    seg.req = nullptr;
    free_slots_.push_back(slot);
    --inflight_;
    if (--req->chunks_left == 0) {
      // last segment: close the fd and FREE the request record — a
      // long-lived handle must not grow memory with every swap
      close(req->fd);
      ++completed_requests_;
      live_requests_.erase(std::find(live_requests_.begin(),
                                     live_requests_.end(), req));
      delete req;
    }
  }

  int64_t block_size_;
  int queue_depth_;
  bool single_submit_;
  int ring_fd_ = -1;
  unsigned sq_entries_ = 0, cq_entries_ = 0;
  bool single_mmap_ = false;
  void* sq_ring_ptr_ = nullptr;
  void* cq_ring_ptr_ = nullptr;
  size_t sq_ring_sz_ = 0, cq_ring_sz_ = 0, sqe_sz_ = 0;
  unsigned *sq_head_ = nullptr, *sq_tail_ = nullptr, *sq_mask_ = nullptr;
  unsigned* sq_array_ = nullptr;
  unsigned *cq_head_ = nullptr, *cq_tail_ = nullptr, *cq_mask_ = nullptr;
  struct io_uring_sqe* sqes_ = nullptr;
  struct io_uring_cqe* cqes_ = nullptr;
  std::vector<SegState> segs_;
  std::vector<int> free_slots_;
  std::vector<RequestState*> live_requests_;
  unsigned to_submit_ = 0;
  unsigned inflight_ = 0;
  int completed_requests_ = 0;
  std::atomic<int> first_error_;
  std::mutex mu_;
};

}  // namespace

AioEngine* CreateUringEngine(int64_t block_size, int queue_depth,
                             int single_submit) {
  return UringEngine::Create(block_size, queue_depth, single_submit != 0);
}

#else  // !DS_HAVE_URING_ABI — no <linux/io_uring.h> at build time

AioEngine* CreateUringEngine(int64_t, int, int) { return nullptr; }

#endif

}  // namespace ds_aio

extern "C" {

// 1 when io_uring_setup works on THIS kernel/sandbox, else 0.  Cached.
int ds_uring_probe() {
  static int cached = -1;
  if (cached >= 0) return cached;
#if DS_HAVE_URING_ABI
  struct io_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = static_cast<int>(syscall(__NR_io_uring_setup, 4u, &p));
  if (fd >= 0) {
    close(fd);
    cached = 1;
  } else {
    cached = 0;  // ENOSYS (pre-5.1), EPERM (seccomp), ...
  }
#else
  cached = 0;
#endif
  return cached;
}

}  // extern "C"
