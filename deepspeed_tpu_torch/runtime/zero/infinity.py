"""ZeRO-Infinity's layer-streaming engine: train a model whose parameters
need not fit on the card (counterpart of
deepspeed_tpu/runtime/zero/infinity.py; reference: stage 3 with
offload_param, stage3.py:932 and partitioned_param_swapper.py).

  card    : the boundary activations and at most two parameter groups at a
            time (the group computing and the one streaming in);
  host    : the compute-dtype groups ("cpu": one pinned flat buffer; "nvme":
            files paged through PartitionedParamSwapper's pinned window),
            the fp32 grad accumulators, and the fp32 master with the Adam
            moments in the host or NVMe optimizer tier (zero/offload.py,
            swap_tensor/optimizer_swapper.py);
  step    : the forward streams the groups up under no_grad, keeping each
            layer's input; the head computes its loss and its grads at
            once; the backward streams them down again and recomputes each
            layer with autograd from its saved input, copying each group's
            grads to the host one group behind the compute; the optimizer
            sweep steps the master and writes the new compute-dtype groups.

The model takes part through `layerwise_api()` (models/gpt2.py).  Each
group's parameters reach the card from pinned host memory on a copy
stream, and the compute stream waits for that copy only.  A group's bytes
in every host buffer, file and accumulator are its leaves in the JAX
order of its tree, so one flat layout (groups in streaming order) serves
the master, the moments, the grads and the compute-dtype copy, and each
group is one span of it.

`offload_param.prefetch_depth` >= 2 issues the next groups' reads before
waiting for the current one, and carries a read across the sweeps (the
backward's first group under the head, the next forward's embed under
the optimizer sweep); 0 reads each group where it is used.  Both give
the same bits.  `deepspeed_tpu_torch.initialize` dispatches here when
`zero_optimization.offload_param` (or the legacy cpu_offload_params) is
set.

Over W data-parallel ranks (the JAX engine takes the data-parallel world
for its batch, infinity.py:125-127, :328-341) every rank streams the
groups to its own card (ranks that share a card share one copy) and runs
its share of the rows: the layer computes and the recompute run rank by
rank, each rank's dropout drawn from a seed of its own (rank 0's the
step's seed).  Each group's fp32 grads are summed over the ranks in rank
order on the card before they go to the host (over a process group the
mesh's all-gather and the same ordered sum), and the tier steps them
divided by gas x W, so the loss is the global batch's mean, the mean of
the W ranks' losses.  One process holds every group's compute-dtype
bytes; under P processes each process's tier holds its range of the flat
layout (zero/offload.py `JaxLeafMap.ranged`, the finite flag and the clip
norm exchanged over the group), and the new ranges are all-gathered into
every process's host buffer after the sweep.  A checkpoint holds the
whole tier (process 0 writes it, gathered from every process's range).
"""

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...config import DeepSpeedConfig
from ...utils.logging import log_dist
from ...utils.timer import ThroughputTimer
from ...utils.tree import tree_flatten
from ..swap_tensor.utils import aligned_empty

TORCH_RNG_KEY = "torch_rng"


def load_sweep_ceiling(backend: str) -> Optional[Dict[str, float]]:
    """The read / write GB/s ceiling of `backend` from the aio sweep file
    that DS_AIO_SWEEP_RESULTS names (its last `aio_best_config` line), the
    denominator of the engine's achieved-rate report; None when the
    variable is unset, the file cannot be read or holds no figure for
    this backend.  The port reads no other file for it."""
    path = os.environ.get("DS_AIO_SWEEP_RESULTS")
    if not path:
        return None
    best = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("metric") == "aio_best_config":
                    best = row
    except OSError:
        return None
    if best is None:
        return None
    ceilings = best.get("ceilings")
    if ceilings is not None:
        if backend not in ceilings:
            return None
        return {"read_gbps": float(ceilings[backend]["read_gbps"]),
                "write_gbps": float(ceilings[backend]["write_gbps"])}
    if "read_gbps" in best:
        return {"read_gbps": float(best["read_gbps"]),
                "write_gbps": float(best["write_gbps"])}
    return None


class _HostFetch:
    """The swap-in handle of a host-resident group: its span, no read."""

    def __init__(self, data: torch.Tensor):
        self._data = data
        self.nbytes = 0
        self.hidden_s = 0.0
        self.exposed_s = 0.0
        self.t_issue = time.perf_counter()

    def wait(self) -> torch.Tensor:
        return self._data


class ZeroInfinityEngine:
    """forward / backward / step over streamed parameter groups."""

    def __init__(self, model=None, config=None, model_parameters=None,
                 optimizer=None, lr_scheduler=None, training_data=None,
                 collate_fn=None, device="cuda", mesh=None):
        from ..engine import _check_process_world, resolve_mesh_ctx
        if not hasattr(model, "layerwise_api"):
            raise ValueError(
                "offload_param requires a model exposing layerwise_api() "
                "(streaming groups) — GPT2Model does")
        if optimizer is not None:
            raise ValueError(
                "offload_param drives the host/NVMe optimizer tier — a "
                "client optimizer cannot be streamed")
        self.module = model
        self.mesh = resolve_mesh_ctx(config, mesh, device)
        world = self.mesh.data_parallel_world_size
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, world_size=world))
        _check_process_world(self.mesh)
        if self.config.fp16.enabled:
            raise ValueError(
                "the streaming engine is bf16/fp32-native; use bf16 instead "
                "of fp16")
        self.world_size = world
        self.local_ranks = list(self.mesh.local_ranks)
        self._devices = [self.mesh.device_of(r) for r in self.local_ranks]
        self.device = self._devices[0]
        self.compute_dtype = (torch.bfloat16 if self.config.bf16.enabled
                              else torch.float32)
        api = model.layerwise_api()
        self._split = api["split"]
        self._embed_fn = api["embed_fn"]
        self._layer_fn = api["layer_fn"]
        self._head_loss_fn = api["head_loss_fn"]
        self.num_layers = api["num_layers"]
        self._order = (["embed"] + [f"layer{i}"
                                    for i in range(self.num_layers)]
                       + ["head"])
        params = (dict(model_parameters) if model_parameters is not None
                  else dict(model.state_dict()))
        self._init_layout(params)

        # ---- the host / NVMe tiers ------------------------------------ #
        from .offload import (HostOffloadOptimizer, JaxLeafMap, TierView,
                              process_exchange)
        zc = self.config.zero_config
        op, oo = zc.offload_param, zc.offload_optimizer
        pin = self.device.type == "cuda"
        procs = self.mesh.process_count
        # this process's range of the layout (padded to a multiple of P):
        # under one controller the whole layout
        chunk = -(-self._size // procs)
        proc = self.local_ranks[0] // len(self.local_ranks)
        self._chunk = (proc * chunk, (proc + 1) * chunk)
        master = torch.zeros(chunk * procs, dtype=torch.float32)
        for name, shape in self._named_shapes:
            s, e = self._name_span[name]
            value = params[name]
            value = (value.detach() if isinstance(value, torch.Tensor)
                     else torch.as_tensor(np.asarray(value)))
            master[s:e].copy_(value.reshape(-1))
        del params
        esize = torch.empty((), dtype=self.compute_dtype).element_size()
        self._host_params = aligned_empty(esize * self._size,
                                          self.compute_dtype,
                                          pin)[:self._size]
        self._host_params.copy_(master[:self._size])
        self._leaf_map = JaxLeafMap(self._named_shapes, None, master.numel())
        tier_map = self._leaf_map
        gather = process_exchange(self.mesh, self.device)
        if procs > 1:
            tier_map = self._leaf_map.ranged([self._chunk])
            master = master[self._chunk[0]:self._chunk[1]].clone()
        self._use_nvme_params = op is not None and op.device == "nvme"
        self._prefetch_depth = int(op.prefetch_depth) if op is not None else 0
        self._swapper = None
        if self._use_nvme_params:
            from ..swap_tensor.optimizer_swapper import nvme_swap_dir
            from ..swap_tensor.partitioned_param_swapper import (
                PartitionedParamSwapper)
            self._swapper = PartitionedParamSwapper(
                nvme_swap_dir(op.nvme_path, "params",
                              proc if procs > 1 else None),
                {g: self._group_tree(g, self._host_params[slice(
                    *self._spans[g])]) for g in self._order},
                buffer_count=max(2, op.buffer_count),
                aio_config=self.config.aio_config,
                retry_policy=self.config.resilience_config
                .build_retry_policy(), pin=pin)
            self._write_groups()
            self._swapper.snapshot_stats()  # set-up writes are no step I/O
            self._swapper.drain_write_events()
        if oo is not None and oo.device == "nvme":
            from ..swap_tensor.optimizer_swapper import (
                create_nvme_offload_optimizer)
            self._opt = create_nvme_offload_optimizer(
                tier_map, master, self.config,
                gradient_clipping=self.config.gradient_clipping,
                process=proc if procs > 1 else None, gather=gather)
        else:
            self._opt = HostOffloadOptimizer(
                tier_map, master, self.config.optimizer_name or "adam",
                self.config.optimizer_params,
                gradient_clipping=self.config.gradient_clipping, pin=pin,
                gather=gather)
        del master
        self._view = TierView(self._opt, self._leaf_map, self._tier_flat,
                              self._tier_part)
        size = tier_map.size
        self._host_grads = aligned_empty(4 * size, torch.float32,
                                         pin)[:size]
        # under processes the sweep writes this process's range here, and
        # the ranges are all-gathered into _host_params
        self._host_out = None
        if procs > 1:
            self._host_out = aligned_empty(esize * size, self.compute_dtype,
                                           pin)[:size]
        biggest = max(e - s for s, e in self._spans.values())
        self._grad_staging = aligned_empty(4 * biggest, torch.float32,
                                           pin)[:biggest]
        self._copy_streams = {
            dev: torch.cuda.Stream(device=dev) for dev in self._devices
            if dev.type == "cuda"}

        # ---- bookkeeping ------------------------------------------------ #
        self.lr_scheduler = lr_scheduler
        self.training_dataloader = self._configure_dataloader(
            training_data, collate_fn)
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._seeds = torch.Generator().manual_seed(42)
        self._grads_fresh = True  # the next micro-step opens a window
        self._acts = None
        self._pending = None
        self._last_loss = None
        self._uploads: List[Any] = []  # events of copies from host_params
        self.max_live_param_groups = 0
        self._live_now = 0
        self._fwd_carry = None
        self._bwd_carry = None
        self._swap_events: List[Dict[str, float]] = []
        self._step_t0: Optional[float] = None
        self.last_swap_stats: Optional[Dict[str, Any]] = None
        self.serialized_swap_steps = 0
        self.aio_backend = (self._swapper.write_handle.backend_name
                            if self._swapper is not None else "none")
        self.sweep_ceiling = (load_sweep_ceiling(self.aio_backend)
                              if self._swapper is not None else None)
        self.tput_timer = ThroughputTimer(
            batch_size=self.config.train_micro_batch_size_per_gpu,
            num_workers=world, steps_per_output=self.config.steps_per_print)
        self.monitor = None
        self._monitor_seq = None
        if self.config.monitor_config.enabled:
            self.monitor = self._configure_monitor()
        log_dist(
            f"ZeroInfinityEngine: {self._leaf_map.num_params:,} params in "
            f"{len(self._order)} streamed groups, params_on="
            f"{'nvme' if self._use_nvme_params else 'host'}, optimizer="
            f"{type(self._opt).__name__}, aio_backend={self.aio_backend}, "
            f"prefetch_depth={self._prefetch_depth}, ranks={world} "
            f"({len(self.local_ranks)} here), devices="
            f"{sorted({str(d) for d in self._devices})}", ranks=[0])

    # ------------------------------------------------------------------ #
    # the flat layout: the groups in streaming order, each group's leaves
    # in the JAX order of its tree
    # ------------------------------------------------------------------ #
    def _init_layout(self, params):
        names = self._split({n: n for n in params})
        self._named_shapes, self._name_span, self._spans = [], {}, {}
        self._group_names: Dict[str, List[str]] = {}
        self._group_rebuild = {}
        off = 0
        for g in self._order:
            leaves, rebuild = tree_flatten(names[g])
            start = off
            for name in leaves:
                shape = tuple(params[name].shape)
                n = int(np.prod(shape)) if shape else 1
                self._named_shapes.append((name, shape))
                self._name_span[name] = (off, off + n)
                off += n
            self._spans[g] = (start, off)
            self._group_names[g] = leaves
            self._group_rebuild[g] = rebuild
        self._size = off
        self._shapes = dict(self._named_shapes)

    def _group_tree(self, g: str, span: torch.Tensor):
        """Group g's tree of views into `span` (its span of a buffer of the
        layout)."""
        start = self._spans[g][0]
        views = []
        for name in self._group_names[g]:
            s, e = self._name_span[name]
            views.append(span[s - start:e - start].view(self._shapes[name]))
        return self._group_rebuild[g](views)

    def _write_groups(self):
        """Every group's file from the compute-dtype host buffer."""
        for g in self._order:
            s, e = self._spans[g]
            self._swapper.write(g, self._host_params[s:e], async_op=True)
        self._swapper.flush_writes()

    def _configure_dataloader(self, training_data, collate_fn):
        """This process's loader (the JAX engine's, infinity.py:328-341):
        micro-batch x its ranks' rows a batch, strided over the
        processes."""
        if training_data is None:
            return None
        from ..dataloader import DeepSpeedDataLoader
        return DeepSpeedDataLoader(
            training_data,
            batch_size=(self.config.train_micro_batch_size_per_gpu
                        * len(self.local_ranks)),
            collate_fn=collate_fn,
            data_parallel_world_size=self.mesh.process_count,
            data_parallel_rank=self.local_ranks[0] // len(self.local_ranks))

    def _configure_monitor(self):
        """The monitor with the swap lane fed: `swap_stats_fn`, the
        per-step swap stats on every record and the swap-in / swap-out
        spans in the trace (the JAX engine's)."""
        from ...monitor import TrainingMonitor
        return TrainingMonitor(
            self.config.monitor_config,
            steps_per_print=self.config.steps_per_print, predictions=None,
            boundary_fn=self._monitor_boundary_reads,
            swap_stats_fn=lambda: self.last_swap_stats,
            meta={"engine": type(self).__name__,
                  "params_on": ("nvme" if self._use_nvme_params else "host"),
                  "aio_backend": self.aio_backend,
                  "prefetch_depth": self._prefetch_depth,
                  "sweep_ceiling": self.sweep_ceiling},
            device=self.device)

    def _monitor_boundary_reads(self) -> Dict[str, Any]:
        lr = None
        if self.lr_scheduler is not None:
            lr = float(self.lr_scheduler.lr_at(self._opt.step_count()))
        return {"lr": lr, "loss_scale": None}

    # ------------------------------------------------------------------ #
    @property
    def optimizer(self):
        return self._opt

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    @property
    def pinned_bytes(self) -> int:
        """Page-locked host bytes of the engine and its tiers."""
        own = [self._host_params, self._host_grads, self._grad_staging]
        return (sum(t.numel() * t.element_size() for t in own
                    if t.is_pinned())
                + self._opt.pinned_bytes
                + (self._swapper.pinned_bytes if self._swapper else 0))

    def estimate_memory(self) -> Dict[str, int]:
        """Bytes a tier holds: the card only the two-group window."""
        esize = torch.empty((), dtype=self.compute_dtype).element_size()
        group_bytes = {g: (e - s) * esize for g, (s, e) in self._spans.items()}
        n = self._leaf_map.num_params
        window = 2 * max(group_bytes.values())
        return {"hbm_param_window": window,
                "host_or_nvme_params": sum(group_bytes.values()),
                "grads_fp32_host": 4 * n,
                "optimizer_fp32_nvme_or_host": 12 * n,
                "total_hbm_params": window}

    # ------------------------------------------------------------------ #
    # carried swap-in: a sweep walks a plan of group names; _take(pos)
    # issues the reads of the next prefetch_depth positions, then waits
    # for pos and uploads it
    # ------------------------------------------------------------------ #
    def _swap_in(self, g: str):
        if self._swapper is not None:
            return self._swapper.swap_in(g)
        s, e = self._spans[g]
        return _HostFetch(self._host_params[s:e])

    def _take(self, st, pos: int, extra: int = 0):
        plan, inflight = st["plan"], st["inflight"]
        if self._prefetch_depth >= 2:
            for k in range(pos, min(pos + self._prefetch_depth, len(plan))):
                if k not in inflight:
                    inflight[k] = self._swap_in(plan[k])
        handle = inflight.pop(pos, None)
        if handle is None:
            handle = self._swap_in(plan[pos])
        src = handle.wait()
        g = plan[pos]
        dev = self._upload(g, src)
        if self._prefetch_depth >= 2 and extra:
            # the head and the tied embed are one compute: issue the pair's
            # second read now, after this group's slot is uploaded
            for k in range(pos + 1, min(pos + self._prefetch_depth + extra,
                                        len(plan))):
                if k not in inflight:
                    inflight[k] = self._swap_in(plan[k])
        if handle.nbytes:
            self._swap_events.append({
                "name": g, "bytes": float(handle.nbytes),
                "hidden_s": handle.hidden_s, "exposed_s": handle.exposed_s,
                "t_issue": handle.t_issue,
                "t_done": handle.t_issue + handle.hidden_s
                + handle.exposed_s})
        self._live_now += 1
        self.max_live_param_groups = max(self.max_live_param_groups,
                                         self._live_now)
        return dev

    def _upload(self, g: str, src: torch.Tensor):
        """Group g's tree on each local rank's card from its host bytes
        (pinned), copied on the card's copy stream, once a card; the
        card's compute stream waits for the copy.  A window slot is
        released only once its copies have landed.  Returns one tree a
        local rank (ranks on one card share it)."""
        s, e = self._spans[g]
        flat = src.reshape(-1).view(self.compute_dtype)
        trees, events = {}, []
        for dev in self._devices:
            if dev in trees:
                continue
            stream = self._copy_streams.get(dev)
            if stream is None:
                on_dev = flat.clone()
            else:
                # allocated on the copy stream, so that the copy need not
                # wait for the compute still reading the memory of an
                # earlier group; recorded on the compute stream that uses it
                cur = torch.cuda.current_stream(dev)
                with torch.cuda.stream(stream):
                    on_dev = torch.empty(e - s, dtype=self.compute_dtype,
                                         device=dev)
                    on_dev.copy_(flat, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                on_dev.record_stream(cur)
                cur.wait_event(ev)
                events.append(ev)
            trees[dev] = self._group_tree(g, on_dev)
        if self._swapper is not None:
            for ev in events:
                ev.synchronize()
            self._swapper.release(g)
        else:
            self._uploads.extend(events)
        return [trees[dev] for dev in self._devices]

    def _drop(self, ref):
        """Callers rebind: `p = self._drop(p)`."""
        self._live_now -= 1
        del ref
        return None

    def _step_seed(self) -> Optional[int]:
        cfg = getattr(self.module, "config", None)
        if cfg is None or not any(getattr(cfg, k, 0.0) > 0.0 for k in (
                "embd_dropout", "attn_dropout", "hidden_dropout")):
            return None
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._seeds))

    def _rank_seeds(self, seed):
        """Each local rank's dropout seed from the step's: rank 0's is the
        step's own, rank r's a fixed function of (seed, r)."""
        if seed is None:
            return [None] * len(self.local_ranks)
        return [(seed + r * 0x9E3779B97F4A7C15) % 2 ** 62
                for r in self.local_ranks]

    def _shard(self, value):
        """Each local rank's rows of this process's batch: contiguous row
        blocks in rank order when the ranks divide its rows, else the
        whole batch to every rank (the training engine's `_shard_batch`)."""
        n = len(self.local_ranks)
        if value is None:
            return [None] * n
        if value.shape[0] % n:
            return [value.to(d) for d in self._devices]
        rows = value.shape[0] // n
        return [value[i * rows:(i + 1) * rows].to(d)
                for i, d in enumerate(self._devices)]

    def _on(self, j):
        """Local rank j's card as the current device (the kernels'
        wrappers launch on it)."""
        dev = self._devices[j]
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _mean_loss(self, losses):
        """The mean of every rank's loss (gathered over the process group),
        on the first local rank's card: the global batch's loss."""
        if self.world_size == 1:
            return losses[0].detach()
        if self.mesh.process_group is not None:
            with self.mesh.forked():
                stacked = self.mesh.all_gather_flat(
                    [loss.detach().reshape(1) for loss in losses])[0]
        else:
            stacked = torch.stack([loss.detach().to(self.device)
                                   for loss in losses])
        return stacked.mean()

    def _rank_sum(self, flats):
        """One group's fp32 grads summed over every rank in rank order (on
        the first local rank's card; over a process group the mesh's
        all-gather and the same ordered sum)."""
        if self.mesh.process_group is not None:
            with self.mesh.forked():
                return self.mesh.all_sum(flats)[0]
        total = flats[0]
        if len(flats) > 1:
            total = total.clone()
            for f in flats[1:]:
                total.add_(f.to(total.device))
        return total

    def _tier_flat(self, part: torch.Tensor) -> torch.Tensor:
        """The whole padded layout of a buffer of this process's range
        (every process's range, all-gathered: a collective)."""
        if self._opt.leaf_map.whole:
            return part
        from .offload import process_all_gather
        return process_all_gather(self.mesh, self.device, part)

    def _tier_part(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's range of a buffer of the whole layout."""
        return whole[self._chunk[0]:self._chunk[1]]

    # ------------------------------------------------------------------ #
    def forward(self, input_ids, labels=None):
        """Stream the groups up and return the loss (detached): the mean
        of every rank's loss on its rows.  The head computes its grads
        here, so backward() starts from them."""
        self.tput_timer.start()
        if self.monitor is not None:
            self.monitor.mark_step_start()
            self._monitor_seq = int(input_ids.shape[-1])
        if self._step_t0 is None:
            self._step_t0 = time.perf_counter()
        seed = self._step_seed()
        seeds = self._rank_seeds(seed)
        ids = self._shard(torch.as_tensor(np.asarray(input_ids) if not
                                          isinstance(input_ids, torch.Tensor)
                                          else input_ids))
        lbl = self._shard(None if labels is None else torch.as_tensor(labels))
        ranks = range(len(self.local_ranks))
        L = self.num_layers
        plan = (["embed"] + [f"layer{i}" for i in range(L)]
                + ["head", "embed"])
        st = {"plan": plan, "inflight": {}}
        if self._fwd_carry is not None:  # issued under the last step()
            st["inflight"][0] = self._fwd_carry
            self._fwd_carry = None
        with torch.no_grad():
            embed_g = self._take(st, 0)
            hs = []
            for j in ranks:
                with self._on(j):
                    hs.append(self._embed_fn(embed_g[j], ids[j], seeds[j]))
            acts = [[h] for h in hs]
            embed_g = self._drop(embed_g)
            for i in range(L):
                p = self._take(st, 1 + i, extra=1 if i == L - 1 else 0)
                for j in ranks:
                    with self._on(j):
                        hs[j] = self._layer_fn(p[j], hs[j], seeds[j], i)
                    acts[j].append(hs[j])
                p = self._drop(p)
        head_g = self._take(st, 1 + L)
        embed_g = self._take(st, 2 + L)
        losses, pending = [], []
        for j in ranks:
            with torch.enable_grad(), self._on(j):
                head_leaves, rebuild = tree_flatten(head_g[j])
                head_leaves = [t.detach().requires_grad_(True)
                               for t in head_leaves]
                wte = embed_g[j]["wte"].detach().requires_grad_(True)
                hh = hs[j].detach().requires_grad_(True)
                loss = self._head_loss_fn(rebuild(head_leaves), {"wte": wte},
                                          hh, ids[j], lbl[j])
                grads = torch.autograd.grad(loss, head_leaves + [wte, hh])
            losses.append(loss)
            pending.append({"dh": grads[-1], "g_head": list(grads[:-2]),
                            "g_wte_head": grads[-2]})
        head_g = self._drop(head_g)
        embed_g = self._drop(embed_g)
        if self._prefetch_depth >= 2 and self._swapper is not None:
            # the backward's first group streams in under the head
            self._bwd_carry = self._swap_in(f"layer{L - 1}")
        self._acts = acts
        self._pending = {"seeds": seeds, "ids": ids, "ranks": pending}
        self._last_loss = self._mean_loss(losses)
        return self._last_loss

    __call__ = forward

    @staticmethod
    def _flat32(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.reshape(-1).float() for t in grads])

    def _start_copy(self, g: str, flat: torch.Tensor):
        """Group g's grads (fp32, summed over the ranks, in its leaves'
        order) to the host, this process's range of them, on the copy
        stream: straight into the accumulator in a window's first
        micro-step, else into the staging buffer, added at `_land`."""
        s, e = self._spans[g]
        lo, hi = self._chunk
        a, b = max(s, lo), min(e, hi)
        if a >= b:
            return (g, None, None)
        src = flat[a - s:b - s]
        dst = (self._host_grads[a - lo:b - lo] if self._grads_fresh
               else self._grad_staging[:b - a])
        stream = self._copy_streams.get(flat.device)
        if stream is None:
            dst.copy_(src)
            return (g, flat, None)
        stream.wait_stream(torch.cuda.current_stream(flat.device))
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        flat.record_stream(stream)
        return (g, flat, ev)

    def _land(self, inflight) -> None:
        g, flat, ev = inflight
        if ev is not None:
            ev.synchronize()
        if flat is not None and not self._grads_fresh:
            s, e = self._spans[g]
            lo, hi = self._chunk
            a, b = max(s, lo), min(e, hi)
            self._host_grads[a - lo:b - lo].add_(self._grad_staging[:b - a])

    def backward(self, loss=None):
        """Stream the groups down, recompute each layer from each rank's
        saved input with autograd and backpropagate; each group's grads,
        summed over the ranks, go to the host fp32 accumulators one group
        behind the compute."""
        if self._pending is None:
            raise RuntimeError("backward() before forward()")
        pend, acts = self._pending, self._acts
        seeds, ids, per = pend["seeds"], pend["ids"], pend["ranks"]
        ranks = range(len(self.local_ranks))
        dh = [p["dh"] for p in per]
        L = self.num_layers
        inflight = self._start_copy("head", self._rank_sum(
            [self._flat32(p["g_head"]) for p in per]))
        plan = [f"layer{i}" for i in reversed(range(L))] + ["embed"]
        st = {"plan": plan, "inflight": {}}
        if self._bwd_carry is not None:  # issued under the head
            st["inflight"][0] = self._bwd_carry
            self._bwd_carry = None
        for pos, i in enumerate(reversed(range(L))):
            p = self._take(st, pos)
            flats = []
            for j in ranks:
                with torch.enable_grad(), self._on(j):
                    leaves, rebuild = tree_flatten(p[j])
                    leaves = [t.detach().requires_grad_(True)
                              for t in leaves]
                    x = acts[j][i].detach().requires_grad_(True)
                    y = self._layer_fn(rebuild(leaves), x, seeds[j], i)
                    grads = torch.autograd.grad(y, leaves + [x], dh[j])
                dh[j] = grads[-1]
                acts[j][i + 1] = None
                flats.append(self._flat32(grads[:-1]))
            total = self._rank_sum(flats)
            self._land(inflight)
            inflight = self._start_copy(f"layer{i}", total)
            p = self._drop(p)
        embed_g = self._take(st, L)
        flats = []
        for j in ranks:
            with torch.enable_grad(), self._on(j):
                leaves, rebuild = tree_flatten(embed_g[j])
                leaves = [t.detach().requires_grad_(True) for t in leaves]
                h0 = self._embed_fn(rebuild(leaves), ids[j], seeds[j])
                g_embed = dict(zip(self._group_names["embed"],
                                   torch.autograd.grad(h0, leaves, dh[j])))
            g_embed["wte"] = (g_embed["wte"].float()
                              + per[j]["g_wte_head"].float())
            flats.append(self._flat32([g_embed[n] for n in
                                       self._group_names["embed"]]))
        total = self._rank_sum(flats)
        self._land(inflight)
        inflight = self._start_copy("embed", total)
        self._land(inflight)
        embed_g = self._drop(embed_g)
        if self._prefetch_depth >= 2 and self._swapper is not None:
            # the next forward's embed streams in under the optimizer
            # sweep (write() keeps the slot coherent when the step
            # rewrites the group's file)
            self._fwd_carry = self._swap_in("embed")
        self._acts = None
        self._pending = None
        self._grads_fresh = False
        self.micro_steps += 1
        return self._last_loss if loss is None else loss

    def step(self):
        """The optimizer sweep at the accumulation boundary: the host or
        NVMe tier steps the master (this process's range of it) from the
        grads divided by gas x W, then the new compute-dtype groups are
        written (to the host buffer, all-gathered from every process's
        range under a process group, or to their files)."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._grads_fresh:
            raise RuntimeError("step() before backward()")
        gas = self.gradient_accumulation_steps()
        lr = None
        if self.lr_scheduler is not None:
            lr = float(self.lr_scheduler.lr_at(self._opt.step_count()))
        for ev in self._uploads:  # copies that still read the host buffer
            ev.synchronize()
        self._uploads = []
        out = self._host_params if self._host_out is None else self._host_out
        applied = self._opt.apply(self._host_grads,
                                  1.0 / (gas * self.world_size), lr, out)
        self._grads_fresh = True
        if applied:
            if self._host_out is not None:
                self._host_params.copy_(
                    self._tier_flat(self._host_out)[:self._size])
            if self._swapper is not None:
                self._write_groups()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        else:
            self.skipped_steps += 1
        self.global_steps += 1
        self.tput_timer.stop(global_step=True)
        self._finalize_swap_stats()
        if self.monitor is not None:
            from ...monitor import record as mrec
            tokens = (self.config.train_batch_size * self._monitor_seq
                      if self._monitor_seq else None)
            self.monitor.end_step(
                self.global_steps, loss=self._last_loss, tokens=tokens,
                counters={mrec.F_SKIPPED_STEPS: self.skipped_steps,
                          mrec.F_DISPATCHES_PER_STEP: None},
                swap=self.last_swap_stats)
        if self.global_steps % self.config.steps_per_print == 0:
            stats = self.last_swap_stats or {}
            extra = ""
            if stats.get("read_bytes"):
                extra = (f", swap_read={stats['read_gbps']:.2f}GB/s, "
                         f"overlap={stats['overlap_fraction']:.0%}")
            log_dist(f"step={self.global_steps}, "
                     f"loss={float(self._last_loss):.6f}{extra}", ranks=[0])

    # ------------------------------------------------------------------ #
    def _finalize_swap_stats(self):
        """The step's swap report (the JAX engine's): bytes read, the read
        rate over the groups' issue-to-done windows (a lower bound), the
        bytes-weighted share of the reads hidden under compute, the
        exposed read and write seconds, and the groups whose read the
        caller waited for (serialized swap-ins)."""
        events, self._swap_events = self._swap_events, []
        t0, self._step_t0 = self._step_t0, None
        if (self.monitor is not None and self.monitor.trace_active
                and self._swapper is not None):
            self.monitor.trace.add_swap_read_events(events,
                                                    step=self.global_steps)
            self.monitor.trace.add_swap_write_events(
                self._swapper.drain_write_events(), step=self.global_steps)
        if self._swapper is None:
            self.last_swap_stats = None
            return
        io = self._swapper.snapshot_stats()
        read_bytes = sum(e["bytes"] for e in events)
        hidden_s = sum(e["hidden_s"] for e in events)
        exposed_s = sum(e["exposed_s"] for e in events)
        overlap_bytes = sum(
            e["bytes"] * (e["hidden_s"] / (e["hidden_s"] + e["exposed_s"]))
            for e in events if e["hidden_s"] + e["exposed_s"] > 0)
        serialized = [e["name"] for e in events
                      if e["exposed_s"] > max(e["hidden_s"], 1e-4)]
        window_s = hidden_s + exposed_s
        stats: Dict[str, Any] = {
            "aio_backend": self.aio_backend,
            "prefetch_depth": self._prefetch_depth,
            "read_bytes": read_bytes,
            "read_exposed_s": exposed_s,
            "read_hidden_s": hidden_s,
            "read_gbps": (read_bytes / window_s / 1e9) if window_s else 0.0,
            "overlap_bytes": overlap_bytes,
            "overlap_fraction": (overlap_bytes / read_bytes
                                 if read_bytes else 1.0),
            "serialized_swap_ins": serialized,
            "serialized_reads_inline": io.get("serialized_reads", 0.0),
            "write_bytes": io.get("write_bytes", 0.0),
            "write_exposed_s": io.get("write_wait_s", 0.0),
            "step_wall_s": (time.perf_counter() - t0) if t0 else 0.0,
        }
        if self.sweep_ceiling is not None and stats["read_gbps"]:
            stats["sweep_read_gbps"] = self.sweep_ceiling["read_gbps"]
            stats["read_vs_ceiling"] = (stats["read_gbps"]
                                        / self.sweep_ceiling["read_gbps"])
        else:
            stats["read_vs_ceiling"] = None
        opt_stats = getattr(self._opt, "last_sweep_stats", None)
        if opt_stats is not None:
            stats["optimizer_sweep"] = dict(opt_stats)
        if serialized and self._prefetch_depth >= 2:
            self.serialized_swap_steps += 1
            log_dist(
                f"[infinity-schedule] WARNING: {len(serialized)} serialized "
                f"swap-in(s) this step ({', '.join(serialized[:4])}"
                f"{'...' if len(serialized) > 4 else ''}) — the read was "
                "paid on the critical path despite prefetch_depth="
                f"{self._prefetch_depth}", ranks=[0])
        self.last_swap_stats = stats

    def swap_stats(self) -> Optional[Dict[str, Any]]:
        """The swap report of the last optimizer step."""
        return self.last_swap_stats

    # ------------------------------------------------------------------ #
    def module_state_dict(self):
        """The fp32 master as the JAX tree (from the optimizer tier; under
        processes gathered from every process's range: a collective)."""
        return self._view.master()

    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        """The JAX streaming engine's checkpoint: the master as the module
        tree, the tier's state_dict as the optimizer, the counters and
        the dropout seeds' generator state in the client state.  Under a
        process group every process calls it and process 0 writes the
        whole tier (the JAX engine's host state, engine.py:2678-2683)."""
        from .. import checkpoint as ckpt_mod
        tag = tag or f"global_step{self.global_steps}"
        client = dict(client_state or {})
        client.update({"global_steps": self.global_steps,
                       "micro_steps": self.micro_steps,
                       "skipped_steps": self.skipped_steps,
                       TORCH_RNG_KEY: self._seeds.get_state().tolist()})
        module, optimizer = self.module_state_dict(), self._view.state()
        path = os.path.join(save_dir, str(tag))
        if self.local_ranks[0] == 0:
            path = ckpt_mod.save_checkpoint_state(
                save_dir, tag, module_state={"module": module},
                optimizer_state={"optimizer": optimizer},
                client_state=client)
        if self.mesh.process_group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.process_group)
        return path

    def load_checkpoint(self, load_dir, tag=None):
        """Load the streaming engine's checkpoint (any process count or
        world it was saved at): the tier's state, this process's range of
        it, and the compute-dtype groups from the master."""
        from .. import checkpoint as ckpt_mod
        module_state, opt_state, client = ckpt_mod.load_checkpoint_state(
            load_dir, tag, {"module": self.module_state_dict()},
            {"optimizer": self._view.state()})
        full = torch.zeros(self._leaf_map.size, dtype=torch.float32)
        self._leaf_map.from_tree(module_state["module"], full)
        if opt_state is not None:
            self._view.load_state(opt_state["optimizer"])
        self._view.load_master_flat(full)
        for ev in self._uploads:
            ev.synchronize()
        self._uploads = []
        self._host_params.copy_(full[:self._size])
        if self._swapper is not None:
            self._write_groups()
            self._swapper.drain_write_events()
        self.global_steps = client.get("global_steps", 0)
        self.micro_steps = client.get("micro_steps", 0)
        self.skipped_steps = client.get("skipped_steps", 0)
        if client.get(TORCH_RNG_KEY) is not None:
            self._seeds.set_state(torch.tensor(client[TORCH_RNG_KEY],
                                               dtype=torch.uint8))
        self._grads_fresh = True
        return load_dir, client
