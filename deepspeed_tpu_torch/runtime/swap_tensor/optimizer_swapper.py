"""The NVMe optimizer tier (counterpart of
deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py; reference:
runtime/swap_tensor/partitioned_optimizer_swapper.py and
pipelined_optimizer_swapper.py, stepped as stage3.py:2777 steps its
sub-groups).

The fp32 master and the Adam moments live in files, one a JAX tree leaf
and kind: `<swap_dir>/leaf<i>_<param|exp_avg|exp_avg_sq>.bin`, raw fp32
bytes in the leaf's C order, i its number in the JAX order — the JAX
tier's files, so a swap directory written by either package reads back
in the other.  A tier over a part of the leaves (one process's ranges, or
a process's stage-3 pieces: zero/offload.py `JaxLeafMap`) keeps each
leaf's part in its file, in a swap directory of its own process.  A step pipelines over the leaves at depth D
(`offload_optimizer.pipeline_depth`, at least 2):

    D-1 reads in flight ; for leaf i: [read leaf i+D-1]
                                      ‖ [host Adam on leaf i]
                                      ‖ [write-back of the leaves < i]

with D buffer sets, each with its own read and write submission contexts,
so a set waits only for its previous leaf's write-back.  The grads come
as the engine's flat host buffer; a layer leaf's rows are gathered from
its spans into one staging buffer, and its new compute-dtype rows are
written back into the engine's flat `out` buffer.  The same native Adam
runs on the same values as the host tier, so the two tiers give the same
bits.
"""

import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...ops.adam.cpu_adam import adam_step_buffers, native_lib
from ...utils.logging import log_dist
from ..zero.offload import KINDS, Gather, JaxLeafMap, _AdamHyper
from .aio_handle import AsyncIOHandle, handle_kwargs
from .utils import aligned_empty


class _BufferSet:
    """One (param, exp_avg, exp_avg_sq, grad, bf16 out) buffer set with its
    own read and write submission contexts."""

    def __init__(self, numel: int, aio_kw: dict):
        self.p, self.m, self.v, self.g = (
            aligned_empty(4 * numel, torch.float32) for _ in range(4))
        self.out = aligned_empty(2 * numel, torch.bfloat16)
        self.read_handle = AsyncIOHandle(**aio_kw)
        self.write_handle = AsyncIOHandle(**aio_kw)

    def views(self, n: int):
        return self.p[:n], self.m[:n], self.v[:n]


def nvme_state_layout(leaf_map: JaxLeafMap, step: int,
                      buffers: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX NVMe tier's state_dict from flat buffers of a whole map:
    {"step", "leaf<k>_<kind>": leaf k} (copies)."""
    sd: Dict[str, Any] = {"step": step}
    for kind in KINDS:
        for k in range(len(leaf_map.leaves)):
            sd[f"leaf{k}_{kind}"] = leaf_map.gather(buffers[kind], k).clone()
    return sd


def nvme_state_buffers(leaf_map: JaxLeafMap, sd: Dict[str, Any]):
    """(step, flat buffers by kind) of a JAX NVMe tier's state_dict, over a
    whole map (the padding zero)."""
    out = {kind: torch.zeros(leaf_map.size, dtype=torch.float32)
           for kind in KINDS}
    for kind in KINDS:
        for k in range(len(leaf_map.leaves)):
            leaf_map.scatter(out[kind], k, sd[f"leaf{k}_{kind}"])
    return int(np.asarray(sd["step"])), out


class NVMeOffloadOptimizer:
    """Adam / AdamW over file-resident fp32 state; the host tier's
    engine-facing API (`apply`, `step_count`, `state_dict`,
    `local_state`, ...)."""

    state_layout = staticmethod(nvme_state_layout)
    state_buffers = staticmethod(nvme_state_buffers)

    def __init__(self, leaf_map: JaxLeafMap, master: torch.Tensor,
                 swap_dir: str, optimizer_name: str = "adam",
                 optimizer_params: Optional[dict] = None,
                 gradient_clipping: float = 0.0, aio_config=None,
                 pipeline_depth: int = 2, gather: Gather = None):
        self.hyper = _AdamHyper(optimizer_name, optimizer_params,
                                gradient_clipping, "NVMe offload")
        self.leaf_map = leaf_map
        self.gather = gather
        self.pipeline_depth = max(2, int(pipeline_depth))
        self._step = 0
        self.pinned_bytes = 0
        self.last_sweep_stats: Optional[Dict[str, float]] = None
        native_lib()
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        kw = handle_kwargs(aio_config)
        self.read_handle = AsyncIOHandle(**kw)
        self.write_handle = AsyncIOHandle(**kw)
        self.aio_backend = self.write_handle.backend_name
        flat = master.detach().reshape(-1).float().cpu()
        biggest = max(leaf.numel for leaf in leaf_map.leaves)
        self._bufs = [_BufferSet(biggest, kw)
                      for _ in range(self.pipeline_depth)]
        zeros = torch.zeros(biggest, dtype=torch.float32)
        held = []  # an async write borrows its buffer until wait()
        for k in range(len(leaf_map.leaves)):
            p = leaf_map.gather(flat, k).reshape(-1).contiguous()
            held.append(p)
            n = p.numel()
            self.write_handle.pwrite(p, self._path(k, "param"), async_op=True)
            for kind in KINDS[1:]:
                self.write_handle.pwrite(zeros[:n], self._path(k, kind),
                                         async_op=True)
        self.write_handle.wait()
        del held
        log_dist(f"ZeRO-Infinity: {leaf_map.num_params} fp32 params and 2x "
                 f"moments in files at {swap_dir} (aio_backend="
                 f"{self.aio_backend}, pipeline_depth={self.pipeline_depth})",
                 ranks=[0])

    def _path(self, k: int, kind: str) -> str:
        return os.path.join(self.swap_dir, f"leaf{k}_{kind}.bin")

    def step_count(self) -> int:
        return self._step

    def _read_leaf(self, k: int, s: _BufferSet) -> None:
        n = self.leaf_map.leaves[k].numel
        for buf, kind in zip(s.views(n), KINDS):
            s.read_handle.pread(buf, self._path(k, kind), async_op=True)

    def _write_leaf(self, k: int, s: _BufferSet) -> None:
        n = self.leaf_map.leaves[k].numel
        for buf, kind in zip(s.views(n), KINDS):
            s.write_handle.pwrite(buf, self._path(k, kind), async_op=True)

    def apply(self, grads: torch.Tensor, scale_inv: float,
              lr: Optional[float], out: Optional[torch.Tensor] = None) -> bool:
        """The host tier's `apply` over the files: False, changing nothing,
        on a non-finite grad; else every leaf read, stepped and written
        back, its new parameters in `out`."""
        h, lm = self.hyper, self.leaf_map
        if not h.prepare(lm, grads, scale_inv, lr, self.gather):
            return False
        self._step += 1
        stats = {"read_wait_s": 0.0, "write_wait_s": 0.0, "adam_s": 0.0,
                 "wall_s": 0.0, "leaves": float(len(lm.leaves)),
                 "bytes_read": 0.0, "bytes_written": 0.0,
                 "pipeline_depth": float(self.pipeline_depth)}
        t_wall = time.perf_counter()
        D, count = self.pipeline_depth, len(lm.leaves)

        def issue_read(j: int) -> None:
            s = self._bufs[j % D]
            if j >= D:
                # the set's previous leaf (j - D) writes back from these
                # buffers: it lands before the read refills them
                t0 = time.perf_counter()
                s.write_handle.wait()
                stats["write_wait_s"] += time.perf_counter() - t0
            self._read_leaf(j, s)
            stats["bytes_read"] += 12 * lm.leaves[j].numel

        for j in range(min(D - 1, count)):
            issue_read(j)
        args = h.step_args(self._step)
        for k, leaf in enumerate(lm.leaves):
            if k + D - 1 < count:
                issue_read(k + D - 1)
            s = self._bufs[k % D]
            t0 = time.perf_counter()
            s.read_handle.wait()
            stats["read_wait_s"] += time.perf_counter() - t0
            n = leaf.numel
            p, m, v = s.views(n)
            g = lm.gather(grads, k, s.g).reshape(-1)
            bf16 = out is not None and out.dtype == torch.bfloat16
            t0 = time.perf_counter()
            adam_step_buffers(p, m, v, g, bf16_out=s.out[:n] if bf16
                              else None, **args)
            stats["adam_s"] += time.perf_counter() - t0
            if out is not None:
                lm.scatter(out, k, s.out[:n] if bf16 else p)
            self._write_leaf(k, s)
            stats["bytes_written"] += 12 * n
        t0 = time.perf_counter()
        for s in self._bufs:
            s.write_handle.wait()
        stats["write_wait_s"] += time.perf_counter() - t0
        stats["wall_s"] = time.perf_counter() - t_wall
        self.last_sweep_stats = stats
        return True

    def _read_all(self, kind: str) -> List[torch.Tensor]:
        out = []
        for k, leaf in enumerate(self.leaf_map.leaves):
            buf = torch.empty(leaf.numel, dtype=torch.float32)
            self.read_handle.pread(buf, self._path(k, kind))
            out.append(buf.view(leaf.shape))
        return out

    @property
    def master_params(self) -> Dict[str, Any]:
        """The fp32 master read back from the files, as the JAX tree."""
        return self.leaf_map.tree([t.numpy() for t in self._read_all("param")])

    def local_state(self, kinds=KINDS) -> Dict[str, torch.Tensor]:
        """The flat buffers of `kinds` (the padding zero), read from the
        files."""
        out = {}
        for kind in kinds:
            flat = torch.zeros(self.leaf_map.size, dtype=torch.float32)
            for k, t in enumerate(self._read_all(kind)):
                self.leaf_map.scatter(flat, k, t)
            out[kind] = flat
        return out

    def load_local_state(self, step: Optional[int],
                         buffers: Dict[str, torch.Tensor]) -> None:
        """Overwrite the files of the kinds given (and the step count,
        unless None) from flat buffers."""
        if step is not None:
            self._step = int(step)
        lm = self.leaf_map
        self._write_all({(k, kind): lm.gather(buf, k).numpy()
                         for kind, buf in buffers.items()
                         for k in range(len(lm.leaves))}, list(buffers))

    def state_dict(self) -> Dict[str, Any]:
        return nvme_state_layout(self.leaf_map, self._step,
                                 self.local_state())

    def _write_all(self, arrays: Dict[str, Any], kinds) -> None:
        held = []
        for k, leaf in enumerate(self.leaf_map.leaves):
            for kind in kinds:
                t = torch.as_tensor(np.ascontiguousarray(
                    np.asarray(arrays[(k, kind)], np.float32))).reshape(-1)
                held.append(t)
                self.write_handle.pwrite(t, self._path(k, kind),
                                         async_op=True)
        self.write_handle.wait()



def nvme_swap_dir(nvme_path: Optional[str], kind: str,
                  process: Optional[int] = None) -> str:
    """`<nvme_path>/zero_stage_3/<kind>` (the JAX package's paths); without
    a path, under this process's temporary directory; `process` (under
    several processes) appends `process<p>`, one directory a process."""
    base = nvme_path or os.path.join(tempfile.gettempdir(),
                                     "deepspeed_tpu_torch_nvme")
    path = os.path.join(base, "zero_stage_3", kind)
    return path if process is None else os.path.join(path,
                                                     f"process{process}")


def create_nvme_offload_optimizer(leaf_map: JaxLeafMap, master: torch.Tensor,
                                  config, gradient_clipping: float = 0.0,
                                  process: Optional[int] = None,
                                  gather: Gather = None):
    """The engines' factory for offload_optimizer.device == "nvme"
    (reference: stage3.py:932 _configure_tensor_swapping); `process` and
    `gather` for a tier over one process's part."""
    oo = config.zero_config.offload_optimizer
    return NVMeOffloadOptimizer(
        leaf_map, master, nvme_swap_dir(oo.nvme_path, "optimizer", process),
        optimizer_name=config.optimizer_name or "adam",
        optimizer_params=config.optimizer_params,
        gradient_clipping=gradient_clipping, aio_config=config.aio_config,
        pipeline_depth=oo.pipeline_depth, gather=gather)
