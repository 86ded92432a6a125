"""Named-axis mesh of logical ranks under one controller (counterpart of
deepspeed_tpu/parallel/mesh.py).

The JAX package names its parallelism axes on a `jax.sharding.Mesh` and
runs per-device code under `shard_map`; one Python process drives every
device.  The port keeps that model: a `MeshContext` holds `world_size`
logical ranks laid out row-major over the five named axes (outer to
inner: ``pipe, data, expert, seq, model``), rank r lives on
``devices[r % len(devices)]``, and a per-rank value is a Python list of
tensors in rank order (or a stacked leading axis where the JAX function is
worker-stacked).  A world the devices cannot hold is not an error: ranks
share a device.  `devices` defaults to every visible CUDA device; the CPU
is used only when the caller passes it.

On CUDA each rank has its own compute stream and its own copy stream.
`forked()` makes every rank's streams wait for the caller's current
stream and, on exit, the caller's stream wait for every rank's; `rank(r)`
runs the enclosed code on rank r's device and compute stream;
`permute` is the ring primitive (`lax.ppermute`): device-to-device copies
on the receivers' copy streams, ordered against the compute streams by
events.  On the CPU all of this degenerates to plain copies in program
order.

The collectives the JAX package leaves to XLA (`all_gather`,
`all_to_all`, `psum_scatter`) are plain tensor code on the caller's
stream.  ZeRO's collectives over the engine's flat buffers
(`reduce_scatter_flat`, `all_gather_flat` and `all_sum` on top of it) run
on the ranks' compute streams instead, ordered by events: each rank reads
a peer's buffer only after the peer's stream reached the call, and no
rank's stream goes past the call before every reader of its buffer is
done.

Under a torch.distributed world of P processes (utils/distributed.py's
`init_distributed`, one process per card) a mesh holds one rank a
process: rank `dist.get_rank()` on the process's card, its data axis P.
`local_ranks` lists the ranks this process drives ([rank] there,
range(world_size) under one controller), and every per-rank list is a
list over them.  ZeRO's collectives then run over the process group with
the single controller's arithmetic: `reduce_scatter_flat` is an
all-to-all of the W chunks followed by the same rank-order sum on the
caller's stream, `all_gather_flat` an `all_gather_into_tensor`, `all_sum`
the gather and the same ordered sum, so that W processes give the bits
W ranks of one process give.  NCCL orders a collective on the stream
current at the call (the rank's compute stream): no host sync, no
barrier.  The collective tier's primitives (`permute`, `all_gather`,
`all_to_all`, `psum_scatter`) are not ported over process groups
(ROADMAP.md A.4c).
"""

import contextlib
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("pipe", "data", "expert", "seq", "model")

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# ZeRO shards over every axis that carries (expert-)data parallelism.
ZERO_AXES = (DATA_AXIS, EXPERT_AXIS)


@dataclass(frozen=True)
class MeshShape:
    pipe: int = 1
    data: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    @property
    def total(self) -> int:
        return self.pipe * self.data * self.expert * self.seq * self.model

    def as_tuple(self):
        return (self.pipe, self.data, self.expert, self.seq, self.model)


def resolve_mesh_shape(n_devices: int, pipe: int = 1, data: int = -1,
                       expert: int = 1, seq: int = 1,
                       model: int = 1) -> MeshShape:
    """Resolve a mesh spec where at most one axis may be -1: that axis
    fills `n_devices`.  With every axis given, the world is their product,
    whatever the number of devices."""
    sizes = {"pipe": pipe, "data": data, "expert": expert, "seq": seq,
             "model": model}
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"Only one mesh axis may be -1, got {wild}")
    if wild:
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed mesh axes {sizes}")
        sizes[wild[0]] = n_devices // fixed
    if min(sizes.values()) < 1:
        raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
    return MeshShape(**sizes)


def process_world() -> Optional[Tuple[int, int]]:
    """(process count, this process's rank) of the torch.distributed world
    when one is up, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return None


def _default_devices() -> List[torch.device]:
    """Every visible card, or under a process world this process's card
    (the one `init_distributed` bound it to)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "MeshContext: no CUDA device is visible; the mesh does not fall "
            "back to the CPU (pass devices=['cpu'] explicitly)")
    if process_world() is not None:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _not_over_processes(what):
    raise NotImplementedError(
        f"{what} over a torch.distributed process group is not ported yet "
        "(ROADMAP.md A.4c, the collective tier over process groups)")


class MeshContext:
    """`world_size` logical ranks over the named axes, mapped onto
    `devices`: all of them driven by this process, or under a process
    world one rank a process (`local_ranks`)."""

    def __init__(self, shape: MeshShape,
                 devices: Optional[Sequence] = None):
        self.shape = shape
        self.axis_sizes = dict(zip(MESH_AXES, shape.as_tuple()))
        self.world_size = shape.total
        devs = _default_devices() if devices is None else \
            [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("MeshContext: `devices` is empty")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"MeshContext: devices must be all 'cuda' or all "
                             f"'cpu', got {devs}")
        self.devices = [torch.device("cuda", d.index or 0)
                        if d.type == "cuda" else d for d in devs]
        self.is_cuda = "cuda" in kinds
        self._coords = np.stack(np.unravel_index(
            np.arange(self.world_size), shape.as_tuple()), axis=1)
        self._compute = self._copy = None  # streams, made at first use
        self._recv = {}  # the all-to-all's receive buffers, by shape
        world = process_world()
        self.process_group = None
        self.process_count = 1
        self.local_ranks = list(range(self.world_size))
        if world is not None:
            count, pid = world
            if shape.data != count or shape.total != count:
                raise ValueError(
                    f"MeshContext: under a torch.distributed world of {count} "
                    f"processes the mesh holds one rank a process on its data "
                    f"axis, so data must be {count}; got data={shape.data} "
                    f"(axes {self.axis_sizes})")
            if len(self.devices) != 1:
                raise ValueError(
                    f"MeshContext: a process of a torch.distributed world "
                    f"drives one device, got {devs}")
            self.process_group = dist.group.WORLD
            self.process_count = count
            self.local_ranks = [pid]

    # -- factory ------------------------------------------------------- #
    @staticmethod
    def create(pipe: int = 1, data: int = -1, expert: int = 1, seq: int = 1,
               model: int = 1, devices=None) -> "MeshContext":
        """The axis that is -1 fills the devices, or under a process world
        the processes."""
        devs = _default_devices() if devices is None else list(devices)
        world = process_world()
        fill = len(devs) if world is None else world[0]
        shape = resolve_mesh_shape(fill, pipe, data, expert, seq, model)
        return MeshContext(shape, devs)

    @staticmethod
    def from_config(mesh_config, devices=None) -> "MeshContext":
        """The mesh of a config's "mesh" block (config.MeshConfig)."""
        return MeshContext.create(
            pipe=mesh_config.pipe, data=mesh_config.data,
            expert=mesh_config.expert, seq=mesh_config.seq,
            model=mesh_config.model, devices=devices)

    # -- layout -------------------------------------------------------- #
    def axis_size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def data_parallel_world_size(self) -> int:
        # the expert axis carves its replicas out of the data-parallel
        # world, so dense data parallelism spans data x expert
        return self.axis_size(DATA_AXIS) * self.axis_size(EXPERT_AXIS)

    @property
    def expert_parallel_world_size(self) -> int:
        return self.axis_size(EXPERT_AXIS)

    @property
    def expert_data_parallel_world_size(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def model_parallel_world_size(self) -> int:
        return self.axis_size(MODEL_AXIS)

    @property
    def pipe_parallel_world_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def seq_parallel_world_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    def axis_index(self, rank: int, axis: str) -> int:
        """Rank's coordinate along `axis` (`lax.axis_index`)."""
        return int(self._coords[rank, MESH_AXES.index(axis)])

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank % len(self.devices)]

    def peer(self, rank: int, axis: str, index: int) -> int:
        """The rank that differs from `rank` only in its coordinate along
        `axis`, which is `index` (taken modulo the axis size)."""
        coords = self._coords[rank].copy()
        coords[MESH_AXES.index(axis)] = index % self.axis_size(axis)
        return int(np.ravel_multi_index(coords, self.shape.as_tuple()))

    def group(self, rank: int, axes) -> List[int]:
        """The ranks that share every coordinate with `rank` except along
        `axes`, in the joint collective's axis-major order (first axis of
        the tuple outermost)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = [rank]
        for ax in axes:
            out = [self.peer(r, ax, i) for r in out
                   for i in range(self.axis_size(ax))]
        return out

    def group_index(self, rank: int, axes) -> int:
        """Rank's position in `group(rank, axes)`."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for ax in axes:
            idx = idx * self.axis_size(ax) + self.axis_index(rank, ax)
        return idx

    def check_ranked(self, name: str, values) -> None:
        """`values` holds one value for each rank this process drives."""
        n = len(self.local_ranks)
        if not isinstance(values, (list, tuple)) or len(values) != n:
            raise ValueError(
                f"{name}: expected one value per rank (a list of "
                f"{n}), got "
                f"{type(values).__name__}"
                + (f" of {len(values)}" if hasattr(values, "__len__") else ""))

    def __repr__(self):
        procs = (f", processes={self.process_count}"
                 if self.process_group is not None else "")
        return (f"MeshContext({self.axis_sizes}, devices="
                f"{[str(d) for d in self.devices]}{procs})")

    # -- streams ------------------------------------------------------- #
    def _streams(self):
        """Each local rank's compute and copy streams, by rank."""
        if self._compute is None:
            self._compute = {r: torch.cuda.Stream(self.device_of(r))
                             for r in self.local_ranks}
            self._copy = {r: torch.cuda.Stream(self.device_of(r))
                          for r in self.local_ranks}
        return self._compute, self._copy

    @contextlib.contextmanager
    def forked(self):
        """Run the enclosed per-rank work on the ranks' own streams: they
        first wait for the caller's current stream of their device, and on
        exit that stream waits for them.  Nothing synchronizes the host."""
        if not self.is_cuda:
            yield
            return
        compute, copy = self._streams()
        callers = {r: torch.cuda.current_stream(self.device_of(r))
                   for r in self.local_ranks}
        for r in self.local_ranks:
            compute[r].wait_stream(callers[r])
            copy[r].wait_stream(callers[r])
        try:
            yield
        finally:
            for r in self.local_ranks:
                callers[r].wait_stream(compute[r])
                callers[r].wait_stream(copy[r])

    @contextlib.contextmanager
    def rank(self, rank: int, wait=()):
        """Run the enclosed code as rank `rank`: on its device and compute
        stream, after the events in `wait` (None entries are skipped)."""
        if not self.is_cuda:
            yield
            return
        stream = self._streams()[0][rank]
        for ev in wait:
            if ev is not None:
                stream.wait_event(ev)
        with torch.cuda.stream(stream):
            yield

    def record(self, rank: int):
        """An event after the work enqueued so far on rank's compute
        stream (None on the CPU)."""
        if not self.is_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._streams()[0][rank])
        return ev

    def copy(self, rank: int, pairs, wait=()):
        """Enqueue `dst.copy_(src)` for every (src, dst) of `pairs` on
        rank's copy stream, after the events in `wait`; returns the event
        that follows the copies (None on the CPU, where they run at
        once)."""
        if not self.is_cuda:
            for src, dst in pairs:
                dst.copy_(src)
            return None
        stream = self._streams()[1][rank]
        for ev in wait:
            if ev is not None:
                stream.wait_event(ev)
        with torch.cuda.stream(stream):
            for src, dst in pairs:
                dst.copy_(src, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    # -- collectives --------------------------------------------------- #
    def permute(self, tensors, axis: str, perm: Sequence[Tuple[int, int]]):
        """`lax.ppermute(x, axis, perm)` over per-rank values: for every
        (src, dst) of `perm` (indices along `axis`), the rank at `dst`
        receives a copy of the value of the rank at `src` in its group.
        Ranks that receive nothing get zeros, as ppermute gives.  Call
        inside `forked()`: each copy runs on the receiver's copy stream
        after the sender's compute stream, and the receiver's compute
        stream waits for it."""
        if self.process_group is not None:
            _not_over_processes("permute")
        self.check_ranked("permute", tensors)
        source = {dst: src for src, dst in perm}
        out = []
        for r in range(self.world_size):
            src_idx = source.get(self.axis_index(r, axis))
            dev = self.device_of(r)
            if src_idx is None:
                with self.rank(r):
                    out.append(torch.zeros_like(tensors[r], device=dev))
                continue
            sender = self.peer(r, axis, src_idx)
            src = tensors[sender]
            if not self.is_cuda:
                out.append(src.clone())
                continue
            compute, copy = self._streams()
            produced = self.record(sender)
            with torch.cuda.stream(copy[r]):
                dst = torch.empty_like(src, device=dev)
            arrived = self.copy(r, [(src, dst)], wait=[produced])
            # the caching allocator must not hand either block out again
            # before the other stream is done with it
            src.record_stream(copy[r])
            dst.record_stream(compute[r])
            compute[r].wait_event(arrived)
            out.append(dst)
        return out

    def all_gather(self, tensors, axes, dim: int):
        """Tiled `lax.all_gather(x, axes, axis=dim, tiled=True)`: every
        rank gets its group's values concatenated along `dim` in
        axis-major order."""
        if self.process_group is not None:
            _not_over_processes("all_gather")
        self.check_ranked("all_gather", tensors)
        return [torch.cat([tensors[g].to(self.device_of(r))
                           for g in self.group(r, axes)], dim=dim)
                for r in range(self.world_size)]

    def all_to_all(self, tensors, axis: str):
        """`lax.all_to_all(x, axis, split_axis=0, concat_axis=0)` for
        values whose leading dimension is the axis size: rank i's row j
        becomes rank j's row i."""
        if self.process_group is not None:
            _not_over_processes("all_to_all")
        self.check_ranked("all_to_all", tensors)
        out = []
        for r in range(self.world_size):
            me = self.axis_index(r, axis)
            out.append(torch.stack([tensors[g][me].to(self.device_of(r))
                                    for g in self.group(r, axis)], dim=0))
        return out

    def psum_scatter(self, tensors, axes, dim: int):
        """Tiled `lax.psum_scatter(x, axes, scatter_dimension=dim,
        tiled=True)`: the group's values summed in group order, each rank
        keeping its chunk of `dim`."""
        if self.process_group is not None:
            _not_over_processes("psum_scatter")
        self.check_ranked("psum_scatter", tensors)
        out = []
        for r in range(self.world_size):
            group = self.group(r, axes)
            size = tensors[r].shape[dim]
            if size % len(group) != 0:
                raise ValueError(
                    f"psum_scatter: dim {dim} (size {size}) must be divisible "
                    f"by the {axes!r} group size {len(group)}")
            chunk = size // len(group)
            start = self.group_index(r, axes) * chunk
            dev = self.device_of(r)
            total = None
            for g in group:
                part = tensors[g].narrow(dim, start, chunk).to(dev)
                total = part if total is None else total + part
            out.append(total)
        return out


    # -- ZeRO's collectives over flat buffers, on the ranks' streams ---- #
    def _barrier(self, groups) -> None:
        """Every rank's compute stream waits until each rank of its group
        is done with the work enqueued so far, so that no rank overwrites
        a buffer its peers still read."""
        done = [self.record(r) for r in range(self.world_size)]
        for r in range(self.world_size):
            with self.rank(r, wait=[done[g] for g in groups[r]]):
                pass

    def _process_group_of(self, axes):
        """Under a process world: the group over `axes` must be the whole
        world (the data axis holds every rank); raise for a sub-group."""
        me = self.local_ranks[0]
        if self.group(me, axes) != list(range(self.world_size)):
            _not_over_processes(f"a collective over the axes {axes!r} of "
                                f"{self.axis_sizes}")
        return self.process_group

    def _receive_buffer(self, like):
        """The all-to-all's receive buffer for tensors like `like`: one a
        shape, dtype and device, made at first use and kept."""
        key = (like.numel(), like.dtype, like.device)
        if key not in self._recv:
            self._recv[key] = torch.empty_like(like)
        return self._recv[key]

    def reduce_scatter_flat(self, tensors, axes=ZERO_AXES):
        """ZeRO's gradient reduce-scatter: every rank gives a 1-D tensor of
        one length L, a multiple of its group's size G; rank r gets the
        [L / G] chunk at its group index, its group's chunks summed in
        group order (as `psum_scatter`).  Call inside `forked()`; the result
        of rank r is ordered on its compute stream, and every input may be
        overwritten on its rank's stream as soon as this returns.  Under a
        process world: an all-to-all of the chunks, then the same ordered
        sum."""
        self.check_ranked("reduce_scatter_flat", tensors)
        locals_ = self.local_ranks
        groups = {r: self.group(r, axes) for r in locals_}
        for r, x in zip(locals_, tensors):
            if x.dim() != 1 or x.numel() % len(groups[r]):
                raise ValueError(
                    f"reduce_scatter_flat: rank {r} gives a tensor of shape "
                    f"{tuple(x.shape)}; it must be 1-D with a length "
                    f"divisible by the group size {len(groups[r])}")
        if self.process_group is not None:
            pg = self._process_group_of(axes)
            (r,), (x,) = locals_, tensors
            with self.rank(r):
                recv = self._receive_buffer(x)
                dist.all_to_all_single(recv, x, group=pg)
                parts = recv.view(self.world_size, -1)
                total = parts[0].clone()
                for part in parts[1:]:
                    total.add_(part)
            return [total]
        ready = [self.record(r) for r in range(self.world_size)]
        out = []
        for r in range(self.world_size):
            group = groups[r]
            chunk = tensors[r].numel() // len(group)
            start = self.group_index(r, axes) * chunk
            dev = self.device_of(r)
            with self.rank(r, wait=[ready[g] for g in group]):
                total = tensors[group[0]].narrow(0, start, chunk).to(
                    dev, copy=True)
                for g in group[1:]:
                    total.add_(tensors[g].narrow(0, start, chunk).to(dev))
            out.append(total)
        self._barrier([groups[r] for r in range(self.world_size)])
        return out

    def all_gather_flat(self, tensors, axes=ZERO_AXES, out=None):
        """ZeRO's tiled all-gather: every rank gives a 1-D tensor of one
        length c; rank r gets its group's tensors concatenated in group
        order, [G * c], written into out[r] when `out` is given (a piece
        that already lies where it belongs is not copied).  Call inside
        `forked()`; ordered as `reduce_scatter_flat`.  Under a process
        world: `all_gather_into_tensor` (in place where the rank's piece
        already lies in `out`)."""
        self.check_ranked("all_gather_flat", tensors)
        gathered = []
        for i, r in enumerate(self.local_ranks):
            n = len(self.group(r, axes)) * tensors[i].numel()
            with self.rank(r):
                dst = (out[i] if out is not None else torch.empty(
                    n, dtype=tensors[i].dtype, device=self.device_of(r)))
            if dst.shape != (n,):
                raise ValueError(
                    f"all_gather_flat: rank {r}'s output has shape "
                    f"{tuple(dst.shape)}, expected ({n},)")
            gathered.append(dst)
        if self.process_group is not None:
            pg = self._process_group_of(axes)
            (r,), (x,), (dst,) = self.local_ranks, tensors, gathered
            with self.rank(r):
                mine = dst.narrow(0, self.group_index(r, axes) * x.numel(),
                                  x.numel())
                in_place = x.data_ptr() == mine.data_ptr() and \
                    dist.get_backend(pg) == "nccl"
                if not in_place and x.untyped_storage().data_ptr() == \
                        dst.untyped_storage().data_ptr():
                    # only NCCL documents the in-place form, and only with
                    # the rank's piece where it belongs
                    x = x.clone()
                with warnings.catch_warnings():
                    # torch 2.13 renames it; 2.11 has only this name
                    warnings.simplefilter("ignore", FutureWarning)
                    dist.all_gather_into_tensor(dst, x, group=pg)
            return gathered
        ready = [self.record(r) for r in range(self.world_size)]
        groups = [self.group(r, axes) for r in range(self.world_size)]
        for r, group in enumerate(groups):
            chunk = tensors[r].numel()
            dst = gathered[r]
            with self.rank(r, wait=[ready[g] for g in group]):
                for i, g in enumerate(group):
                    piece = dst.narrow(0, i * chunk, chunk)
                    if piece.data_ptr() != tensors[g].data_ptr() or \
                            piece.device != tensors[g].device:
                        piece.copy_(tensors[g])
        self._barrier(groups)
        return gathered

    def all_sum(self, tensors, axes=ZERO_AXES):
        """Every rank gets the sum over its group, in group order, of the
        group's tensors (one shape on every rank): an `all_gather_flat`,
        then the same ordered sum on each rank, so that every rank holds
        the same bits.  Call inside `forked()`."""
        gathered = self.all_gather_flat([t.reshape(-1) for t in tensors],
                                        axes)
        out = []
        for r, x, full in zip(self.local_ranks, tensors, gathered):
            with self.rank(r):
                parts = full.view(-1, x.numel())
                total = parts[0].clone()
                for part in parts[1:]:
                    total.add_(part)
            out.append(total.view(x.shape))
        return out


# ---------------------------------------------------------------------- #
# Global mesh registry, as the JAX package keeps one.
# ---------------------------------------------------------------------- #
_MESH_CTX: Optional[MeshContext] = None


def initialize_mesh(pipe: int = 1, data: int = -1, expert: int = 1,
                    seq: int = 1, model: int = 1,
                    devices=None) -> MeshContext:
    global _MESH_CTX
    _MESH_CTX = MeshContext.create(pipe=pipe, data=data, expert=expert,
                                   seq=seq, model=model, devices=devices)
    return _MESH_CTX


def set_mesh_context(ctx: MeshContext) -> None:
    global _MESH_CTX
    _MESH_CTX = ctx


def get_mesh_context(required: bool = True) -> Optional[MeshContext]:
    if _MESH_CTX is None and required:
        raise RuntimeError(
            "Mesh is not initialized — call "
            "deepspeed_tpu_torch.parallel.initialize_mesh(...) first")
    return _MESH_CTX


def reset_mesh_context() -> None:
    global _MESH_CTX
    _MESH_CTX = None
