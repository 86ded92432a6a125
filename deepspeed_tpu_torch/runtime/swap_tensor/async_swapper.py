"""AsyncTensorSwapper — fire-and-forget tensor writes to NVMe (counterpart of
deepspeed_tpu/runtime/swap_tensor/async_swapper.py; reference:
runtime/swap_tensor/async_swapper.py AsyncTensorSwapper).

A tensor handed to swap_out is staged into one of the pool's aligned
buffers and written asynchronously; each buffer has its own submission
context, so waiting one write (its InflightTensorWrite) reclaims only its
buffer.  Issue and wait times are kept for the monitor's trace.
"""

import time
from typing import List, Optional

import torch

from .aio_handle import AsyncIOHandle
from .utils import SwapBuffer, SwapBufferPool


class InflightTensorWrite:
    """One issued swap_out; wait() lands it and reclaims its buffer.
    `hidden_s` is the time the disk worked before the caller waited,
    `exposed_s` the time the caller blocked."""

    def __init__(self, swapper: "AsyncTensorSwapper", buf: SwapBuffer,
                 handle: AsyncIOHandle, path: str, nbytes: int):
        self._swapper = swapper
        self._buf = buf
        self._handle = handle
        self.path = path
        self.nbytes = nbytes
        self._done = False
        self.t_issue = time.perf_counter()
        self.hidden_s: Optional[float] = None
        self.exposed_s: Optional[float] = None

    def wait(self) -> None:
        if self._done:
            return
        t0 = time.perf_counter()
        try:
            self._handle.wait()
        finally:
            # a failed write still frees its slot: later swap_outs then see
            # the I/O error, not an exhausted pool
            self._done = True
            t1 = time.perf_counter()
            self.hidden_s = t0 - self.t_issue
            self.exposed_s = t1 - t0
            self._swapper._retire(self, t1)

    @property
    def done(self) -> bool:
        return self._done


class AsyncTensorSwapper:
    def __init__(self, handle: AsyncIOHandle, buffer_bytes: int,
                 buffer_count: int = 4):
        self.handle = handle
        self.pool = SwapBufferPool(buffer_bytes, buffer_count)
        # one submission context a buffer, with the template's knobs
        self._handles: List[AsyncIOHandle] = [
            AsyncIOHandle(block_size=handle.block_size,
                          queue_depth=handle.queue_depth,
                          single_submit=handle.single_submit,
                          overlap_events=handle.overlap_events,
                          thread_count=handle.thread_count,
                          backend=handle.backend)
            for _ in range(buffer_count)]
        self._inflight: List[InflightTensorWrite] = []
        self._write_events: List[dict] = []

    def drain_write_events(self) -> List[dict]:
        """Return and reset the completed writes' issue-to-done windows."""
        done, self._write_events = self._write_events, []
        return done

    def swap_out(self, tensor: torch.Tensor, path: str) -> InflightTensorWrite:
        """Stage `tensor` into a pool buffer and write it asynchronously."""
        if self.pool.free_count == 0:
            self.synchronize()
        buf = self.pool.allocate()
        handle = self._handles[self.pool.index(buf)]
        src = tensor.detach().reshape(-1)
        try:
            view = buf.view(src.numel(), src.dtype)
            view.copy_(src)
            handle.pwrite(view, path, async_op=True)
        except BaseException:
            self.pool.release(buf)  # the submission failed: no leak
            raise
        op = InflightTensorWrite(self, buf, handle, path,
                                 src.numel() * src.element_size())
        self._inflight.append(op)
        return op

    def _retire(self, op: InflightTensorWrite, t_done: float) -> None:
        if op in self._inflight:
            self._inflight.remove(op)
            self.pool.release(op._buf)
            self._write_events.append({
                "name": op.path.rsplit("/", 1)[-1], "bytes": float(op.nbytes),
                "t_issue": op.t_issue, "t_done": t_done,
                "wait_s": op.exposed_s})
            del self._write_events[:-512]

    def synchronize(self) -> None:
        """Wait for every write in flight and reclaim the buffers."""
        for op in list(self._inflight):
            op.wait()
