// Shared backend interface for the host async file I/O engines.
//
// Three engines implement it (selected via ds_aio_create2's backend id,
// plumbed from the `aio.backend` config key by
// deepspeed_tpu_torch/runtime/swap_tensor/aio_handle.py):
//
//   0  threadpool — the original pthread pool issuing one positional
//      pread/pwrite syscall per block_size chunk (host_aio.cpp).
//   1  batched    — same pool, but workers drain up to queue_depth chunks
//      per lock acquisition and coalesce contiguous runs into a single
//      preadv/pwritev submission (host_aio.cpp).  Portable everywhere.
//   2  io_uring   — kernel submission/completion rings, queue_depth SQEs
//      per io_uring_enter, completions reaped in bulk (uring_aio.cpp).
//      Runtime-probed: ds_uring_probe() == 0 on pre-5.1 kernels and in
//      seccomp sandboxes that deny the syscalls.
//
// All engines keep the same contract as the reference's aio_handle
// (csrc/aio/py_lib/deepspeed_py_aio_handle.cpp:282): Submit() enqueues one
// whole-file request split into block_size segments, Wait() blocks until
// every in-flight request lands and returns the completed-request count or
// the first -errno.

#ifndef DS_AIO_BACKEND_H_
#define DS_AIO_BACKEND_H_

#include <stdint.h>

namespace ds_aio {

enum Backend {
  kThreadPool = 0,
  kBatched = 1,
  kIoUring = 2,
};

class AioEngine {
 public:
  virtual ~AioEngine() {}
  // Enqueue one read/write of num_bytes between buffer and path.
  // Returns 0 or -errno on submission failure.
  virtual int Submit(bool is_read, char* buffer, int64_t num_bytes,
                     const char* path) = 0;
  // Block until all submitted requests complete.  Returns the number of
  // completed requests since the last Wait(), or the first -errno.
  virtual int Wait() = 0;
  virtual int backend() const = 0;
};

// uring_aio.cpp — returns nullptr when io_uring is unavailable.
AioEngine* CreateUringEngine(int64_t block_size, int queue_depth,
                             int single_submit);

}  // namespace ds_aio

#endif  // DS_AIO_BACKEND_H_
