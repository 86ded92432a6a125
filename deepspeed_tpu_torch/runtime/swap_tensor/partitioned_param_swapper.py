"""The parameter swapper: compute-dtype parameter groups paged between files
and a window of pinned host buffers (counterpart of
deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py; reference:
runtime/swap_tensor/partitioned_param_swapper.py
AsyncPartitionedParameterSwapper, wired at stage3.py:932).

The unit of paging is a layer group of the streaming engine (embed, one
group a layer, head).  A group's file, `param_group_<name>.bin`, holds its
leaves' bytes one after another in the JAX order of its tree (sorted
keys), the JAX swapper's layout.  `buffer_count` aligned, pinned host
buffers absorb the asynchronous reads, one submission context each, so
finishing one slot's read never waits for another's.

`swap_in(name)` issues the read at once and returns an InflightGroupRead,
the handle the engine carries while the previous group computes; its
issue and wait times split the read into the part hidden under compute and
the part the caller waited for.  `get` / `prefetch` / `release` are the
fire-and-forget forms over the same machinery.
"""

import os
import time
from typing import Any, Dict, List, Optional

import torch

from ...utils.logging import log_dist
from ...utils.tree import tree_flatten
from .aio_handle import AsyncIOHandle, handle_kwargs
from .utils import aligned_empty


class _Group:
    """One group's inventory: its leaves' shapes and dtypes, in the JAX
    order of its tree, and its size in bytes."""

    def __init__(self, name: str, tree: Any):
        self.name = name
        leaves, self._rebuild = tree_flatten(tree)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.sizes = [leaf.numel() for leaf in leaves]
        self.nbytes = sum(n * torch.empty((), dtype=d).element_size()
                          for n, d in zip(self.sizes, self.dtypes))

    def flatten(self, tree: Any) -> torch.Tensor:
        """The group's file bytes (uint8) of a tree of its structure."""
        leaves, _ = tree_flatten(tree)
        return torch.cat([leaf.detach().to("cpu", dtype).reshape(-1)
                          .view(torch.uint8) for leaf, dtype
                          in zip(leaves, self.dtypes)])

    def unflatten(self, buf: torch.Tensor) -> Any:
        """The group's tree of views into `buf` (its bytes)."""
        leaves, off = [], 0
        flat = buf.reshape(-1).view(torch.uint8)
        for shape, dtype, n in zip(self.shapes, self.dtypes, self.sizes):
            nb = n * torch.empty((), dtype=dtype).element_size()
            leaves.append(flat[off:off + nb].view(dtype).view(shape))
            off += nb
        return self._rebuild(leaves)


class InflightGroupRead:
    """One issued swap-in.  wait() blocks only on this group's window slot
    and returns its bytes (a view into the window, valid until the group
    is released); `hidden_s` is the time between the issue and the wait,
    `exposed_s` the time the caller blocked."""

    def __init__(self, swapper: "PartitionedParamSwapper", name: str):
        self.swapper = swapper
        self.name = name
        self.nbytes = swapper.groups[name].nbytes
        self.t_issue = time.perf_counter()
        self.hidden_s: Optional[float] = None
        self.exposed_s: Optional[float] = None
        self._buf = None

    @property
    def done(self) -> bool:
        return self._buf is not None

    def wait(self) -> torch.Tensor:
        if self._buf is None:
            t0 = time.perf_counter()
            self._buf = self.swapper.get_bytes(self.name)
            t1 = time.perf_counter()
            self.hidden_s = t0 - self.t_issue
            self.exposed_s = t1 - t0
            st = self.swapper.stats
            st["read_bytes"] += self.nbytes
            st["read_hidden_s"] += self.hidden_s
            st["read_exposed_s"] += self.exposed_s
        return self._buf


class PartitionedParamSwapper:
    """Pages named parameter groups between files and a host window:
    write(name, data) — (over)write a group's file (a tree of its
    structure, or its bytes); swap_in(name) -> handle; get(name) -> the
    group's tree (copies); get_bytes(name) -> its bytes in the window;
    prefetch(name); release(name); resident_groups."""

    def __init__(self, swap_dir: str, groups: Dict[str, Any],
                 buffer_count: int = 4, aio_config=None, retry_policy=None,
                 pin: bool = False):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.retry_policy = retry_policy
        self.groups = {name: _Group(name, tree)
                       for name, tree in groups.items()}
        kw = handle_kwargs(aio_config)
        self.write_handle = AsyncIOHandle(**kw)
        max_bytes = max(g.nbytes for g in self.groups.values())
        self.buffer_count = max(2, int(buffer_count))
        self._read_handles = [AsyncIOHandle(**kw)
                              for _ in range(self.buffer_count)]
        self._buffers = [aligned_empty(max_bytes, torch.uint8, pin)
                         for _ in range(self.buffer_count)]
        self.pinned_bytes = self.buffer_count * max_bytes if pin else 0
        self._free: List[int] = list(range(self.buffer_count))
        self._resident: Dict[str, int] = {}
        self._pending: Dict[str, int] = {}
        self._lru: List[str] = []
        self._inflight_writes: List[torch.Tensor] = []
        self.stats: Dict[str, float] = {
            "read_bytes": 0.0, "read_hidden_s": 0.0, "read_exposed_s": 0.0,
            "prefetch_hits": 0.0, "serialized_reads": 0.0,
            "write_bytes": 0.0, "write_wait_s": 0.0}
        self._write_events: List[Dict[str, float]] = []
        log_dist(f"ZeRO-Infinity param swapper: {len(self.groups)} groups, "
                 f"window={self.buffer_count} x {max_bytes >> 20}MiB at "
                 f"{swap_dir} (aio_backend={self.write_handle.backend_name})",
                 ranks=[0])

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_dir, f"param_group_{name}.bin")

    def _io(self, fn, what: str):
        """One submission under the retry policy, when there is one (a
        pread / pwrite submission is idempotent)."""
        if self.retry_policy is None:
            return fn()
        return self.retry_policy.run(fn, what=what)

    @property
    def resident_groups(self) -> List[str]:
        return list(self._resident) + list(self._pending)

    def snapshot_stats(self) -> Dict[str, float]:
        """Return and reset the cumulative I/O counters."""
        snap = dict(self.stats)
        for k in self.stats:
            self.stats[k] = 0.0
        return snap

    def _evict_for(self, name: str) -> int:
        if self._free:
            return self._free.pop()
        for cand in list(self._lru):
            if cand in self._resident and cand != name:
                idx = self._resident.pop(cand)
                self._lru.remove(cand)
                return idx
        raise RuntimeError(
            f"param swapper window exhausted ({self.buffer_count} buffers, "
            f"pending={list(self._pending)}) — raise "
            "offload_param.buffer_count")

    def _complete_pending(self, name: str) -> None:
        idx = self._pending.pop(name)
        self._read_handles[idx].wait()  # this slot's read only
        self._resident[name] = idx
        self._lru.append(name)

    def write(self, name: str, data: Any, async_op: bool = False) -> None:
        """(Over)write group `name`'s file from a tree of its structure or
        from its bytes.  A read of the group in flight completes first
        (it reads the file this write truncates), and a resident copy is
        updated."""
        g = self.groups[name]
        if name in self._pending:
            self._complete_pending(name)
        flat = (data.reshape(-1).view(torch.uint8)
                if isinstance(data, torch.Tensor) else g.flatten(data))
        if flat.numel() != g.nbytes:
            raise ValueError(f"group {name}: {flat.numel()} bytes, its "
                             f"file holds {g.nbytes}")
        if name in self._resident:
            self._buffers[self._resident[name]][:g.nbytes].copy_(flat)
        self._inflight_writes.append(flat)  # borrowed until the wait
        self._write_events.append({"name": name, "bytes": float(g.nbytes),
                                   "t_issue": time.perf_counter()})
        self._io(lambda: self.write_handle.pwrite(
            flat, self._path(name), async_op=async_op), "swap.pwrite")
        self.stats["write_bytes"] += g.nbytes
        if not async_op:
            self.flush_writes()

    def flush_writes(self) -> None:
        t0 = time.perf_counter()
        self.write_handle.wait()
        t1 = time.perf_counter()
        self.stats["write_wait_s"] += t1 - t0
        self._inflight_writes.clear()
        for ev in self._write_events:
            if "t_done" not in ev:
                ev["t_done"] = t1
                ev["wait_s"] = t1 - t0
        del self._write_events[:-512]

    def drain_write_events(self) -> List[Dict[str, float]]:
        """Return and reset the completed writes' windows."""
        done = [e for e in self._write_events if "t_done" in e]
        self._write_events = [e for e in self._write_events
                              if "t_done" not in e]
        return done

    def prefetch(self, name: str) -> None:
        if name in self._resident or name in self._pending:
            return
        g = self.groups[name]
        idx = self._evict_for(name)
        buf = self._buffers[idx][:g.nbytes]
        self._io(lambda: self._read_handles[idx].pread(
            buf, self._path(name), async_op=True), "swap.pread")
        self._pending[name] = idx

    def swap_in(self, name: str) -> InflightGroupRead:
        """Issue the group's read now and return the carryable handle."""
        self.prefetch(name)
        return InflightGroupRead(self, name)

    def get_bytes(self, name: str) -> torch.Tensor:
        """The group's bytes in its window slot (read now when no read is
        in flight: a serialized swap-in).  Valid until release(name)."""
        g = self.groups[name]
        if name in self._pending:
            self._complete_pending(name)
            self.stats["prefetch_hits"] += 1
        elif name not in self._resident:
            self.stats["serialized_reads"] += 1
            idx = self._evict_for(name)
            buf = self._buffers[idx][:g.nbytes]
            self._io(lambda: self._read_handles[idx].pread(
                buf, self._path(name), async_op=False), "swap.pread")
            self._resident[name] = idx
            self._lru.append(name)
        else:
            self._lru.remove(name)
            self._lru.append(name)
        return self._buffers[self._resident[name]][:g.nbytes]

    def get(self, name: str) -> Any:
        """The group's tree, copied out of the window."""
        return self.groups[name].unflatten(self.get_bytes(name).clone())

    def release(self, name: str) -> None:
        if name in self._pending:
            self._complete_pending(name)
        if name in self._resident:
            self._free.append(self._resident.pop(name))
            if name in self._lru:
                self._lru.remove(name)
