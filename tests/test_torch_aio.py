"""The NVMe tier's file engines (deepspeed_tpu_torch/runtime/swap_tensor/,
the port's copy of csrc/aio/ built by AsyncIOBuilder), as
tests/unit/test_aio.py holds the JAX package's: every backend round-trips
byte for byte (odd sizes across block boundaries included) and agrees with
the synchronous Python engine, its plain twin; a short read and a failed
write fail loudly; io_uring asked for where it does not work falls back
to the batched pool with a log line and a degradation record; a file
written by the JAX package's handle reads back in the port's, and the
other way round."""

import unittest.mock as mock

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.swap_tensor import AsyncIOHandle as JaxHandle
from deepspeed_tpu_torch.runtime.resilience.degradation import get_registry
from deepspeed_tpu_torch.runtime.swap_tensor import aio_handle as aio_mod
from deepspeed_tpu_torch.runtime.swap_tensor.aio_handle import (
    AsyncIOHandle, io_uring_available, resolve_backend)
from deepspeed_tpu_torch.runtime.swap_tensor.async_swapper import (
    AsyncTensorSwapper)
from deepspeed_tpu_torch.runtime.swap_tensor.utils import (AIO_ALIGN_BYTES,
                                                           SwapBufferPool,
                                                           aligned_empty)

NATIVE = ("threadpool", "batched") + (("io_uring",) if io_uring_available()
                                      else ())


def _bytes(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, size=n, dtype=np.uint8))


@pytest.mark.parametrize("backend", NATIVE + ("python",))
def test_backends_round_trip_odd_sizes(tmp_path, backend):
    """Sizes around the 4096-byte block (a short tail chunk, many chunks)
    written and read back exactly, asynchronously and not; the bytes equal
    the Python engine's file."""
    h = AsyncIOHandle(block_size=4096, queue_depth=4, thread_count=2,
                      backend=backend)
    assert h.backend_name == backend
    plain = AsyncIOHandle(backend="python")
    for n in (1, 4095, 4096, 4097, 40_001, 1_000_003):
        data = _bytes(n, n % 97)
        path, twin = str(tmp_path / f"n{n}.bin"), str(tmp_path / f"p{n}.bin")
        h.pwrite(data, path, async_op=True)
        h.wait()
        plain.pwrite(data, twin)
        out = torch.empty_like(data)
        h.pread(out, path, async_op=n % 2 == 0)
        h.wait()
        assert torch.equal(out, data)
        with open(path, "rb") as a, open(twin, "rb") as b:
            assert a.read() == b.read()
    h.close()


@pytest.mark.parametrize("backend", ("batched", "python"))
def test_short_read_and_failed_write_fail_loudly(tmp_path, backend):
    """Reading more bytes than the file holds raises (EIO), never leaving
    stale bytes; a write into a missing directory raises; a swap_out whose
    write fails at wait frees its buffer."""
    h = AsyncIOHandle(thread_count=1, backend=backend)
    path = str(tmp_path / "t.bin")
    h.pwrite(torch.arange(1000, dtype=torch.float32), path)
    with pytest.raises(OSError):
        h.pread(torch.empty(2000), path)
    with pytest.raises(OSError):
        h.pwrite(torch.zeros(10), str(tmp_path / "no" / "dir" / "x.bin"))
        h.wait()
    with pytest.raises(ValueError, match="contiguous"):
        h.pwrite(torch.zeros(64, 64)[:, ::2], path)
    sw = AsyncTensorSwapper(h, buffer_bytes=64 * 1024, buffer_count=2)
    op = sw.swap_out(torch.zeros(100), str(tmp_path / "ok.bin"))
    with mock.patch.object(op._handle, "wait",
                           side_effect=OSError(28, "injected ENOSPC")):
        with pytest.raises(OSError):
            op.wait()
    assert op.done and sw.pool.free_count == 2


def test_io_uring_falls_back_to_batched_with_a_record(monkeypatch):
    """Where the io_uring probe fails, an explicit io_uring request runs
    the batched pool, warns once, and records aio: io_uring -> batched in
    the degradation registry; auto resolves to batched without a record."""
    monkeypatch.setattr(aio_mod, "io_uring_available", lambda: False)
    monkeypatch.setattr(aio_mod, "_URING_FALLBACK_WARNED", False)
    warnings = []
    monkeypatch.setattr(aio_mod.logger, "warning",
                        lambda msg, *a: warnings.append(str(msg)))
    get_registry().clear()
    assert resolve_backend("auto") == "batched"
    assert get_registry().events() == []
    for _ in range(2):
        h = AsyncIOHandle(backend="io_uring")
        assert h.backend_name == "batched" and h.using_native
        h.close()
    assert sum("falling back" in w for w in warnings) == 1
    events = get_registry().events()
    assert [(e["subsystem"], e["from_tier"], e["to_tier"], e["count"])
            for e in events] == [("aio", "io_uring", "batched", 2)]
    get_registry().clear()
    with pytest.raises(ValueError, match="aio.backend"):
        resolve_backend("libaio")


def test_files_cross_between_the_packages(tmp_path):
    """A file the JAX handle wrote reads back in the port's handle bit for
    bit, and the other way round (the NVMe tiers share their files)."""
    data = np.random.RandomState(0).randn(50_001).astype(np.float32)
    jh, ph = JaxHandle(thread_count=2), AsyncIOHandle(thread_count=2)
    jh.pwrite(data, str(tmp_path / "jax.bin"))
    out = torch.empty(data.size)
    ph.pread(out, str(tmp_path / "jax.bin"))
    assert np.array_equal(out.numpy().view(np.uint32), data.view(np.uint32))
    ph.pwrite(torch.from_numpy(data) * 2, str(tmp_path / "port.bin"))
    back = np.empty_like(data)
    jh.pread(back, str(tmp_path / "port.bin"))
    assert np.array_equal(back, data * 2)
    jh.close()
    ph.close()


def test_aligned_buffers_and_pool():
    """aligned_empty's first element sits on a 4096-byte boundary; the pool
    hands out and takes back its buffers, refusing a double release."""
    for n, dtype in ((1, torch.uint8), (12345, torch.float32),
                     (7, torch.bfloat16)):
        t = aligned_empty(n, dtype)
        assert t.data_ptr() % AIO_ALIGN_BYTES == 0 and t.dtype == dtype
        assert t.numel() * t.element_size() >= n
    pool = SwapBufferPool(4096, 2)
    a = pool.allocate()
    assert a.view(1024).numel() == 1024 and pool.free_count == 1
    with pytest.raises(ValueError, match="too small"):
        a.view(2048)
    pool.release(a)
    with pytest.raises(RuntimeError, match="double release"):
        pool.release(a)


def test_swapper_writes_land_after_the_temporaries_die(tmp_path):
    """swap_out stages each tensor into its buffer: temporaries freed while
    their writes fly still land byte for byte, and every buffer returns."""
    h = AsyncIOHandle(block_size=4096, queue_depth=4, thread_count=2,
                      backend="batched")
    sw = AsyncTensorSwapper(h, buffer_bytes=256 * 1024, buffer_count=3)
    expect = {}
    for i in range(8):
        a = torch.from_numpy(np.random.RandomState(i).randn(50_000)
                             .astype(np.float32))
        expect[i] = a.clone()
        sw.swap_out(a, str(tmp_path / f"g{i}.bin"))
        del a
    sw.synchronize()
    assert sw.pool.free_count == 3 and len(sw.drain_write_events()) == 8
    for i, a in expect.items():
        out = torch.empty_like(a)
        h.pread(out, str(tmp_path / f"g{i}.bin"))
        assert torch.equal(out, a)
    h.close()
