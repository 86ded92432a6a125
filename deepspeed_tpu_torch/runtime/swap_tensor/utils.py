"""Swap buffers (counterpart of deepspeed_tpu/runtime/swap_tensor/utils.py;
reference: runtime/swap_tensor/utils.py SwapBuffer / SwapBufferPool):
host buffers whose base address is AIO_ALIGN_BYTES-aligned, reused
across swap operations.

`aligned_empty(..., pin=True)` takes the buffer from page-locked memory
(torch's pinned host allocator) and aligns it inside a slightly larger
block, so one buffer serves both the file engine and an asynchronous copy
to or from the card.
"""

from typing import List

import torch

AIO_ALIGN_BYTES = 4096


def aligned_empty(num_bytes: int, dtype=torch.float32,
                  pin: bool = False) -> torch.Tensor:
    """A 1-D CPU tensor of `dtype` covering at least `num_bytes`, its first
    element at an AIO_ALIGN_BYTES-aligned address; pinned when `pin`."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    count = max(1, (int(num_bytes) + itemsize - 1) // itemsize)
    raw = torch.empty(count * itemsize + AIO_ALIGN_BYTES, dtype=torch.uint8,
                      pin_memory=pin)
    offset = (-raw.data_ptr()) % AIO_ALIGN_BYTES
    return raw[offset:offset + count * itemsize].view(dtype)


class SwapBuffer:
    """One reusable aligned buffer with typed views."""

    def __init__(self, num_bytes: int, pin: bool = False):
        self.num_bytes = int(num_bytes)
        self.data = aligned_empty(num_bytes, torch.uint8, pin=pin)

    def view(self, count: int, dtype=torch.float32) -> torch.Tensor:
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        if nbytes > self.num_bytes:
            raise ValueError(
                f"swap buffer too small: need {nbytes}, have {self.num_bytes}")
        return self.data[:nbytes].view(dtype)


class SwapBufferPool:
    """A fixed pool of equal buffers (reference SwapBufferPool)."""

    def __init__(self, num_bytes: int, count: int, pin: bool = False):
        self.buffers: List[SwapBuffer] = [SwapBuffer(num_bytes, pin)
                                          for _ in range(count)]
        self._free = list(range(count))

    def allocate(self) -> SwapBuffer:
        if not self._free:
            raise RuntimeError("swap buffer pool exhausted")
        return self.buffers[self._free.pop()]

    def index(self, buf: SwapBuffer) -> int:
        return next(i for i, b in enumerate(self.buffers) if b is buf)

    def release(self, buf: SwapBuffer) -> None:
        idx = self.index(buf)
        if idx in self._free:
            raise RuntimeError("double release of swap buffer")
        self._free.append(idx)

    @property
    def free_count(self) -> int:
        return len(self._free)
