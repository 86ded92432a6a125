"""ctypes wrapper over the native async file I/O engines (counterpart of
deepspeed_tpu/runtime/swap_tensor/aio_handle.py; reference:
csrc/aio/py_lib/deepspeed_py_aio_handle.cpp `aio_handle`).

The knobs are the `aio` config block's (block_size, queue_depth,
single_submit, overlap_events, thread_count) and `aio.backend`, which picks
the engine behind the same pread / pwrite / wait API:

  io_uring   — kernel SQ/CQ rings (csrc/host/uring_aio.cpp), probed at run
               time: absent on pre-5.1 kernels and under seccomp.
  batched    — the portable batched-submission pool (host_aio.cpp).
  threadpool — one syscall a chunk (host_aio.cpp).
  auto       — io_uring when the probe passes, else batched.

The library is built by ops/op_builder.AsyncIOBuilder; a failed build
raises.  io_uring requested where it does not work falls back to the
batched pool, as in the JAX module: logged once and recorded in the
degradation registry (runtime/resilience/degradation.py), never silent.

`backend="python"` selects the synchronous Python engine, the plain twin
the tests hold the native engines against.  Nothing picks it on its own.

Buffers are contiguous CPU tensors, passed by `data_ptr()`; an
asynchronous request borrows its buffer until wait() returns.
"""

import ctypes
from typing import Optional

import torch

from ...constants import (AIO_BACKEND_AUTO, AIO_BACKEND_BATCHED,
                          AIO_BACKEND_IO_URING, AIO_BACKEND_THREADPOOL,
                          AIO_BACKENDS)
from ...ops.op_builder import AsyncIOBuilder
from ...utils.logging import logger

AIO_BACKEND_PYTHON = "python"
# the native engines' ids (csrc/host/aio_backend.h Backend)
_BACKEND_IDS = {AIO_BACKEND_THREADPOOL: 0, AIO_BACKEND_BATCHED: 1,
                AIO_BACKEND_IO_URING: 2}
_LIB: Optional[ctypes.CDLL] = None
_URING_FALLBACK_WARNED = False


def get_aio_lib() -> ctypes.CDLL:
    """The engines' library, built and loaded once a process; raises
    RuntimeError with g++'s stderr when it cannot be built."""
    global _LIB
    if _LIB is None:
        lib = AsyncIOBuilder().load()
        P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ds_aio_create2.restype = P
        lib.ds_aio_create2.argtypes = [I64, INT, INT, INT, INT, INT]
        lib.ds_aio_destroy.argtypes = [P]
        lib.ds_aio_backend.restype = INT
        lib.ds_aio_backend.argtypes = [P]
        lib.ds_uring_probe.restype = INT
        lib.ds_uring_probe.argtypes = []
        for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite):
            fn.restype = INT
            fn.argtypes = [P, P, I64, ctypes.c_char_p, INT]
        lib.ds_aio_wait.restype = INT
        lib.ds_aio_wait.argtypes = [P]
        _LIB = lib
    return _LIB


def io_uring_available() -> bool:
    """Whether the io_uring syscalls work on this kernel and sandbox."""
    return bool(get_aio_lib().ds_uring_probe())


def _degraded(from_tier, to_tier, reason):
    from ..resilience.degradation import record
    record("aio", from_tier, to_tier, reason)


def resolve_backend(backend: str = AIO_BACKEND_AUTO) -> str:
    """The engine that will run for a requested `aio.backend`: io_uring
    asked for where it does not work becomes the batched pool, logged
    once and recorded as a degradation."""
    global _URING_FALLBACK_WARNED
    if backend == AIO_BACKEND_PYTHON:
        return backend
    if backend not in AIO_BACKENDS:
        raise ValueError(
            f"aio.backend={backend!r} — supported: {list(AIO_BACKENDS)}")
    have_uring = io_uring_available()
    if backend == AIO_BACKEND_AUTO:
        return AIO_BACKEND_IO_URING if have_uring else AIO_BACKEND_BATCHED
    if backend == AIO_BACKEND_IO_URING and not have_uring:
        if not _URING_FALLBACK_WARNED:
            _URING_FALLBACK_WARNED = True
            logger.warning(
                "aio.backend=io_uring requested but io_uring_setup failed on "
                "this kernel/sandbox (needs Linux >= 5.1 and a seccomp policy "
                "that allows it) — falling back to the batched-submission "
                "pool")
        _degraded(AIO_BACKEND_IO_URING, AIO_BACKEND_BATCHED,
                  "io_uring probe failed on this kernel/sandbox")
        return AIO_BACKEND_BATCHED
    return backend


def handle_kwargs(aio_config) -> dict:
    """AsyncIOHandle kwargs from a config.AioConfig (every swapper builds
    its handles through this)."""
    if aio_config is None:
        return {}
    return dict(block_size=aio_config.block_size,
                queue_depth=aio_config.queue_depth,
                single_submit=aio_config.single_submit,
                overlap_events=aio_config.overlap_events,
                thread_count=aio_config.thread_count,
                backend=aio_config.backend)


class AsyncIOHandle:
    """One submission context (the reference's aio_handle)."""

    def __init__(self, block_size: int = 1048576, queue_depth: int = 8,
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = 4, backend: str = AIO_BACKEND_AUTO):
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.single_submit = single_submit
        self.overlap_events = overlap_events
        self.thread_count = thread_count
        self._handle = None
        self._sync_completed = 0
        resolved = resolve_backend(backend)
        self.backend = resolved
        if resolved == AIO_BACKEND_PYTHON:
            return
        self._lib = get_aio_lib()
        self._handle = self._create(resolved)
        if self._handle is None and resolved == AIO_BACKEND_IO_URING:
            # the probe passed but the ring could not be made
            logger.warning("io_uring engine creation failed after a "
                           "successful probe; using the batched pool")
            _degraded(AIO_BACKEND_IO_URING, AIO_BACKEND_BATCHED,
                      "engine creation failed after a successful probe")
            self.backend = AIO_BACKEND_BATCHED
            self._handle = self._create(self.backend)
        if self._handle is None:
            raise RuntimeError(f"the native {self.backend} aio engine could "
                               "not be created")

    def _create(self, backend):
        return self._lib.ds_aio_create2(
            self.block_size, self.queue_depth, int(self.single_submit),
            int(self.overlap_events), self.thread_count, _BACKEND_IDS[backend])

    @property
    def using_native(self) -> bool:
        return self._handle is not None

    @property
    def backend_name(self) -> str:
        return self.backend

    @staticmethod
    def _check(rc: int, op: str, path: str):
        if rc < 0:
            raise OSError(-rc, f"aio {op} failed for {path}")

    @staticmethod
    def _check_buffer(buffer: torch.Tensor, op: str) -> None:
        """The engine works on the raw pointer: a strided view would be
        read or filled across its gaps, so it is refused."""
        if not isinstance(buffer, torch.Tensor) or \
                buffer.device.type != "cpu" or not buffer.is_contiguous():
            raise ValueError(f"aio {op} requires a contiguous CPU tensor")

    def pread(self, buffer: torch.Tensor, path: str,
              async_op: bool = False) -> None:
        """Fill `buffer` from the first buffer.nbytes bytes of `path`.  A
        file shorter than that fails (EIO), never leaving stale bytes."""
        self._check_buffer(buffer, "pread")
        nbytes = buffer.numel() * buffer.element_size()
        if self._handle is not None:
            rc = self._lib.ds_aio_pread(self._handle, buffer.data_ptr(),
                                        nbytes, path.encode(), int(async_op))
            self._check(rc, "pread", path)
            return
        with open(path, "rb") as f:
            data = f.read(nbytes)
        if len(data) < nbytes:
            raise OSError(5, f"aio pread short read for {path}: wanted "
                             f"{nbytes} bytes, file holds {len(data)}")
        buffer.reshape(-1).view(torch.uint8).copy_(
            torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self._sync_completed += 1

    def pwrite(self, buffer: torch.Tensor, path: str,
               async_op: bool = False) -> None:
        """Write `buffer`'s bytes as the whole of `path`."""
        self._check_buffer(buffer, "pwrite")
        nbytes = buffer.numel() * buffer.element_size()
        if self._handle is not None:
            rc = self._lib.ds_aio_pwrite(self._handle, buffer.data_ptr(),
                                         nbytes, path.encode(), int(async_op))
            self._check(rc, "pwrite", path)
            return
        with open(path, "wb") as f:
            f.write(buffer.reshape(-1).view(torch.uint8).numpy().tobytes())
        self._sync_completed += 1

    def wait(self) -> int:
        """Block until every request in flight lands; the number of
        completed requests, or OSError for the first failure."""
        if self._handle is not None:
            rc = self._lib.ds_aio_wait(self._handle)
            self._check(rc, "wait", "<batch>")
            return rc
        n, self._sync_completed = self._sync_completed, 0
        return n

    def close(self):
        if self._handle is not None:
            self._lib.ds_aio_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
