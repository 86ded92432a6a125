"""ZeRO-3 parameter streaming: gather at use with a bounded live set
(counterpart of deepspeed_tpu/runtime/zero/stage3_streaming.py).

The JAX module runs the stacked layer scan inside a `shard_map` over the
ZeRO axes: each scan step all-gathers one group of layers from the ranks'
shards, the group is freed when the step ends, the group size keeps
`layers_per_step x params_per_layer` within `stage3_max_live_parameters`,
and the gather's transpose reduce-scatters the group's gradients in fp32.
The port keeps that plan (`plan_layer_streaming`, `StreamPlan`, the same
strings) and runs it over the ranks of a single-controller mesh, in group
lockstep: group i is gathered for every local rank, run on every rank's
hidden states, then released, before group i + 1.  Per-rank compute runs
on the caller's stream (a rank's device's current stream).

Gathered groups are never saved for the backward (the JAX module's
invariant, stage3_streaming.py:43-56).  The three prefetch modes:

- `off`: each group is gathered at use.  The gather is one autograd node
  over every rank's shards (`_GatherGroup`), whose backward is the
  group's reduce-scatter; autograd keeps the layers' other activations,
  and a `saved_tensors_hooks` pair stands in for the JAX checkpoint-name
  policy: a saved tensor that lies in a gathered buffer is kept as a
  token, and its first unpack in the backward gathers the group again
  (released by the group's reduce-scatter).
- `unrolled`: `off`'s structure with group i + 1's gather issued before
  group i's compute (the JAX unroll-2 body leaves that overlap to XLA's
  scheduler; here it is issued, as in `carried`, on the ranks' copy
  streams).  The plan's even group count is the JAX plan's.
- `carried`: the JAX hand-written VJP (`_build_carried_stream`): one
  autograd node for the whole layer stack; the forward runs without a
  graph, issues group i + 1's gather on the ranks' copy streams before
  group i's compute and saves only the group-boundary activations and
  the shards; the backward gathers group S - 1, issues S - 2, and walks
  back, recomputing each group from its saved input (dropout redrawn from
  the generator state saved before its forward,
  activation_checkpointing `recompute_generator`) and reduce-scattering
  its gradients.

With the model's activation checkpointing (the JAX model hands
`stream.scan` its `jax.checkpoint`-ed layer body) each layer runs as one
`_RematLayer` node, which saves the layer's input and its parameters and
recomputes the layer in the backward.  It is an autograd Function, not a
non-reentrant `torch.utils.checkpoint`: that one keeps its inputs by
reference, so a gathered group would stay live through the backward, and
its own saved-tensor hooks would shadow the stream's.  The Function's
saved parameters go through the stream's hooks like any saved tensor, so
in `off` and `unrolled` they are tokens and the recompute reaches them
through the backward's gather, and the live set keeps the plan's bound.
In `carried` the backward's recompute of a group runs its layers as
`_RematLayer`s, so every layer runs three times a step (the forward, the
group's recompute, the layer's own), as in the JAX program.  Each
recompute redraws its dropout from the generator state saved before the
layer's forward (`recompute_generator`), so a rematted step is bitwise
the same step without recompute.

The wire: a plain gather concatenates the ranks' compute-dtype pieces;
its transpose promotes each rank's gradient to fp32, sums the ranks in
rank order and rounds back (`f32_psum_scatter`'s contract).  With the
`low_bandwidth` block each float leaf of a layer group takes its
per-direction bits from `_leaf_wire_bits`, on the group's pieces stacked
[g, ...] as the JAX stream's grouped leaves: qwZ through
`low_bandwidth_all_gather`, qgZ through `quantized_psum_scatter`, and
with `fused_collective_matmul` the per-tile transports `fcm_all_gather` /
`fcm_reduce_scatter` (runtime/comm/low_bandwidth.py,
ops/collective_matmul.py); the quantized and fused routes run in program
order on the compute stream.  The non-layer leaves (embeddings, final
LayerNorm) are gathered once a forward by the plain wire and stay live
through the backward, as the JAX engine's GSPMD gathers them outside the
stream.
"""

import logging
import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ...constants import ZERO_OPTIMIZATION_PREFETCH_MODES as PREFETCH_MODES
from ...ops.collective_matmul import fcm_all_gather, fcm_reduce_scatter
from ...parallel.mesh import ZERO_AXES, MeshContext
from ...utils.logging import log_dist
from ..activation_checkpointing.checkpointing import recompute_generator
from ..comm.low_bandwidth import (f32_psum_scatter, largest_divisor_at_most,
                                  low_bandwidth_all_gather,
                                  quantized_gather_saves_bytes,
                                  quantized_psum_scatter)
from .partition import resolve_hpz_axes


@dataclass(frozen=True)
class StreamPlan:
    """How the layer stack is grouped and prefetched (the JAX class):
    `mode` is the structure applied, `forfeited` why a requested prefetch
    fell back to `off`."""
    layers_per_step: int
    prefetch: bool
    num_layers: int
    params_per_layer: int
    mode: str = "off"
    forfeited: Optional[str] = None

    @property
    def live_parameters(self) -> int:
        """Worst-case simultaneously-gathered parameter count."""
        mult = 2 if self.prefetch else 1
        return mult * self.layers_per_step * self.params_per_layer


def plan_layer_streaming(num_layers: int, params_per_layer: int,
                         max_live_parameters: int,
                         prefetch_bucket_size: int,
                         prefetch_mode: str = "carried") -> StreamPlan:
    """The stage-3 knobs as a (group, prefetch) plan, the JAX function's
    rule and strings: `carried` needs >= 2 groups, `unrolled` an even
    group count, both a live budget of >= 2 layers; a bucket smaller than
    one layer is prefetch off (no forfeit)."""
    if prefetch_mode not in PREFETCH_MODES:
        raise ValueError(
            f"stage3_prefetch_mode={prefetch_mode!r} — supported modes are "
            f"{list(PREFETCH_MODES)}")
    base_budget = max(1, int(max_live_parameters) // max(
        1, params_per_layer))
    wants = (prefetch_mode != "off" and
             int(prefetch_bucket_size) >= params_per_layer)
    want_prefetch = wants and base_budget >= 2
    forfeited = None
    if wants and not want_prefetch:
        forfeited = (
            f"stage3_max_live_parameters holds {base_budget} layer(s) — "
            "a double buffer needs at least 2 (current + prefetched "
            "group)")
    if want_prefetch:
        budget = base_budget // 2
        if prefetch_mode == "carried":
            candidates = [g for g in range(1, budget + 1)
                          if num_layers % g == 0 and num_layers // g >= 2]
            if candidates:
                return StreamPlan(layers_per_step=max(candidates),
                                  prefetch=True, num_layers=num_layers,
                                  params_per_layer=params_per_layer,
                                  mode="carried")
            forfeited = (
                f"{num_layers} layer(s) cannot form >= 2 groups within "
                f"the double-buffer budget of {budget} group(s)")
        else:
            candidates = [g for g in range(1, budget + 1)
                          if num_layers % g == 0 and
                          (num_layers // g) % 2 == 0
                          and num_layers // g >= 2]
            if candidates:
                return StreamPlan(layers_per_step=max(candidates),
                                  prefetch=True, num_layers=num_layers,
                                  params_per_layer=params_per_layer,
                                  mode="unrolled")
            forfeited = (
                f"no group size with an EVEN group count divides "
                f"{num_layers} layers within the double-buffer budget of "
                f"{budget} group(s) (unrolled prefetch pairs groups; "
                f"stage3_prefetch_mode=carried has no such constraint)")
    g = largest_divisor_at_most(num_layers, base_budget)
    return StreamPlan(layers_per_step=g, prefetch=False,
                      num_layers=num_layers,
                      params_per_layer=params_per_layer, mode="off",
                      forfeited=forfeited)


class _Call(nn.Module):
    """Runs a method of `model` under `functional_call`'s parameter swap
    (a rank's gathered non-layer leaves in place of the model's)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(*args)


@dataclass
class _Saved:
    """What a saved tensor that lay in a gathered buffer is kept as: the
    group, rank and leaf it viewed, and the view."""
    group: int
    rank: int
    leaf: int
    size: tuple
    stride: tuple
    offset: int


class _Pass:
    """One forward's state: every rank's compute-dtype shards a region
    (kept for the backward's gathers), the gathered groups live now, the
    backward's gathers."""

    def __init__(self, stream, regions):
        self.stream = stream
        self.regions = regions          # [rank][region] 1-D tensors
        self.nonlayer = None            # [rank] {name: tensor}
        self.live = {}                  # storage ptr -> (group, rank, leaf)
        self.again = {}                 # (group, rank) -> [leaf] tensors
        self.regathered = set()         # groups the backward gathered
        self.pending = {}               # group -> [rank] copy events
        self.lock = threading.Lock()

    def group_regions(self, g):
        return [regs[g] for regs in self.regions]

    def pack(self, t):
        try:
            ptr = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        hit = self.live.get(ptr)
        if hit is None:
            return t
        group, rank, leaf, base = hit
        return _Saved(group, rank, leaf, tuple(t.shape), tuple(t.stride()),
                      t.storage_offset() - base)

    def unpack(self, saved):
        """A saved gathered tensor in the backward: the rank's leaves of
        the group gathered again, rank by rank.  A rank that reaches a
        group is done with the groups after it (the gradient of its input
        came through them): those are released, so that each card holds
        one group of its rank's even where the ranks' backwards run on
        several cards' threads at once."""
        if not isinstance(saved, _Saved):
            return saved
        key = (saved.group, saved.rank)
        stream = self.stream
        with self.lock:
            fulls = self.again.get(key)
            if fulls is None:
                for done in [k for k in self.again
                             if k[1] == saved.rank and k[0] > saved.group]:
                    stream._account_rank(saved.rank, self.again.pop(done),
                                         -1)
                if saved.group not in self.regathered:
                    self.regathered.add(saved.group)
                    stream.counts["gathers"] += 1
                fulls = stream._gather(saved.group,
                                       self.group_regions(saved.group),
                                       only=saved.rank)[saved.rank]
                stream._account_rank(saved.rank, fulls, +1)
                self.again[key] = fulls
        full = fulls[saved.leaf]
        return full.as_strided(saved.size, saved.stride,
                               full.storage_offset() + saved.offset)

    def hold(self, g, fulls):
        for i, rank in enumerate(fulls):
            for k, t in enumerate(rank):
                self.live[t.untyped_storage().data_ptr()] = (
                    g, i, k, t.storage_offset())

    def drop(self, fulls):
        for rank in fulls:
            for t in rank:
                self.live.pop(t.untyped_storage().data_ptr(), None)

    def release_again(self, g):
        with self.lock:
            for key in [k for k in self.again if k[0] == g]:
                self.stream._account_rank(key[1], self.again.pop(key), -1)


class _GatherGroup(torch.autograd.Function):
    """Group g gathered for every local rank from their compute-dtype
    shards (`regions`, one 1-D tensor a rank); the backward reduce-scatters
    the group's gradients into each owner's shard."""

    @staticmethod
    def forward(ctx, run, g, asynchronous, *regions):
        ctx.run, ctx.g = run, g
        fulls = run.stream._gather(g, list(regions),
                                   run if asynchronous else None)
        ctx.leaves = len(fulls[0])
        return tuple(t for rank in fulls for t in rank)

    @staticmethod
    def backward(ctx, *grads):
        run, g, k = ctx.run, ctx.g, ctx.leaves
        run.release_again(g)
        per_rank = [list(grads[i * k:(i + 1) * k])
                    for i in range(len(grads) // k)]
        return (None, None, None) + tuple(run.stream._scatter(g, per_rank))


class _LayerCall:
    """One layer of a rematted group: the layer module, its parameters'
    names, the generator its forward draws from, a function giving the
    generator its recompute draws from, and the rank's device."""

    def __init__(self, stream, layer, j, generator, replay, deterministic):
        self.stream, self.layer, self.j = stream, layer, j
        self.generator, self.replay = generator, replay
        self.deterministic = deterministic

    def run(self, h, params, generator):
        with self.stream._device(self.j):
            return functional_call(
                self.layer, dict(zip(self.stream._layer_names, params)), (h,),
                {"generator": generator, "deterministic": self.deterministic})


class _RematLayer(torch.autograd.Function):
    """A layer whose activations are not saved: the forward runs it
    without a graph and saves its input and parameters (through the
    saved-tensor hooks active around it); the backward runs it again on
    them, its masks redrawn (`_LayerCall.replay`), and takes the grads of
    the input and the parameters."""

    @staticmethod
    def forward(ctx, call, h, *params):
        ctx.call = call
        ctx.save_for_backward(h, *params)
        return call.run(h, params, call.generator)

    @staticmethod
    def backward(ctx, grad):
        h, *params = ctx.saved_tensors
        call, needs = ctx.call, ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip([h] + params, needs)]
            out = call.run(inputs[0], inputs[1:], call.replay())
            wanted = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad,
                                           allow_unused=True))
        return (None,) + tuple(next(got) if t.requires_grad else None
                               for t in inputs)


class _CarriedStream(torch.autograd.Function):
    """The carried double-buffer executor (the JAX
    `_build_carried_stream`): inputs are every rank's hidden states, then
    every layer group's compute-dtype shards rank by rank; saved are the
    group-boundary activations and those shards, never a gathered
    group."""

    @staticmethod
    def forward(ctx, run, generators, deterministic, *tensors):
        stream = run.stream
        n = len(generators)
        hs = list(tensors[:n])
        steps = len(stream.layer_regions)
        cur = stream._gather(1, run.group_regions(1))
        stream._account(cur, +1)
        c_ins, replays = [], []
        for i in range(steps):
            nxt = None
            if i + 1 < steps:
                nxt = stream._gather(2 + i, run.group_regions(2 + i), run)
                stream._account(nxt, +1)
            stream._wait(1 + i, run)
            c_ins.append(hs)
            if stream._remat:
                # two generators a layer at its state: the group's
                # recompute draws from one, the layer's own from the other
                group = [[] for _ in generators]
                replays.append(group)
                hs = [stream._run_group(
                    i, j, h, cur[j], generators[j], deterministic,
                    before_layer=lambda j=j: group[j].append(tuple(
                        recompute_generator(generators[j])
                        for _ in range(2))))
                      for j, h in enumerate(hs)]
            else:
                replays.append([recompute_generator(gen)
                                for gen in generators])
                hs = [stream._run_group(i, j, h, cur[j], generators[j],
                                        deterministic)
                      for j, h in enumerate(hs)]
            stream._account(cur, -1)
            cur = nxt
        ctx.run, ctx.replays, ctx.det = run, replays, deterministic
        ctx.n, ctx.steps = n, steps
        ctx.input_grads = ctx.needs_input_grad[3:3 + n]
        ctx.save_for_backward(*[h for hs_i in c_ins for h in hs_i],
                              *tensors[n:])
        return tuple(hs)

    @staticmethod
    def backward(ctx, *g_out):
        run, n, steps = ctx.run, ctx.n, ctx.steps
        stream = run.stream
        saved = ctx.saved_tensors
        c_ins = [saved[i * n:(i + 1) * n] for i in range(steps)]
        g_h = list(g_out)
        region_grads = [None] * steps
        cur = stream._gather(steps, run.group_regions(steps))
        stream._account(cur, +1)
        for i in range(steps - 1, -1, -1):
            nxt = None
            if i > 0:
                nxt = stream._gather(i, run.group_regions(i), run)
                stream._account(nxt, +1)
            stream._wait(1 + i, run)
            grads = []
            for j in range(n):
                with torch.enable_grad(), stream._device(j):
                    x = c_ins[i][j].detach().requires_grad_(
                        i > 0 or ctx.input_grads[j])
                    fulls = [f.detach().requires_grad_() for f in cur[j]]
                    if stream._remat:
                        out = stream._run_group(i, j, x, fulls, None,
                                                ctx.det,
                                                replays=ctx.replays[i][j])
                    else:
                        out = stream._run_group(i, j, x, fulls,
                                                ctx.replays[i][j](), ctx.det)
                    inputs = ([x] if x.requires_grad else []) + fulls
                    got = torch.autograd.grad(out, inputs, g_h[j],
                                              allow_unused=True)
                if x.requires_grad:
                    g_h[j], got = got[0], got[1:]
                else:
                    g_h[j] = None
                grads.append(list(got))
            stream._account(cur, -1)
            region_grads[i] = stream._scatter(1 + i, grads)
            cur = nxt
        return ((None, None, None) + tuple(g_h)
                + tuple(t for i in range(steps) for t in region_grads[i]))


class Zero3StreamContext:
    """The streaming executor of one engine: the plan, the leaves of each
    region of the ranks' flat buffers, and the forward's gathers.  The
    engine builds it at stage 3 and installs it in the model
    (`GPT2Model.install_zero3_streaming`); the model's rank-lockstep
    forward calls `call` and `scan`."""

    def __init__(self, mesh_ctx: MeshContext, max_live_parameters: int,
                 prefetch_bucket_size: int,
                 persistence_threshold: int = 0,
                 low_bandwidth=None, prefetch_mode: str = "carried"):
        self.ctx = mesh_ctx
        self.max_live_parameters = int(max_live_parameters)
        self.prefetch_bucket_size = int(prefetch_bucket_size)
        self.prefetch_mode = prefetch_mode
        self.persistence_threshold = int(persistence_threshold)
        self.axis_sizes = {a: mesh_ctx.axis_size(a) for a in ZERO_AXES}
        self.manual = frozenset(
            a for a in ZERO_AXES if mesh_ctx.axis_size(a) > 1)
        self._plan_logged = False
        self.lbc = (low_bandwidth if low_bandwidth is not None and
                    getattr(low_bandwidth, "enabled", False) else None)
        self.fcm = bool(self.lbc is not None and getattr(
            self.lbc, "fused_collective_matmul", False))
        self.param_manual = self.manual
        self.param_axis_sizes = dict(self.axis_sizes)
        self.last_plan: Optional[StreamPlan] = None
        if self.lbc is not None and self.lbc.hpz_group_size > 1:
            hpz = resolve_hpz_axes(self.axis_sizes,
                                   self.lbc.hpz_group_size)
            self.param_manual = frozenset(hpz) & self.manual
            self.param_axis_sizes = {
                a: (self.axis_sizes[a] if a in self.param_manual else 1)
                for a in ZERO_AXES}
        self.axes = tuple(a for a in ZERO_AXES if a in self.manual)
        self.world = int(np.prod([self.axis_sizes[a] for a in ZERO_AXES]))
        self.layout = None
        self._pass = None
        self._call = None
        self.counts = {"gathers": 0, "scatters": 0}
        # per-layer recompute (the model's activation checkpointing), set
        # by each scan
        self._remat = False
        # gathered bytes held for each local rank, and the most at once
        self.live_bytes = [0] * len(mesh_ctx.local_ranks)
        self.peak_live_bytes = 0

    @property
    def active(self) -> bool:
        """Streaming is a no-op on a 1-way ZeRO mesh."""
        return bool(self.manual)

    def usable(self) -> bool:
        """True when the streamed forward can run: a ZeRO world above 1
        and a forward bound by the engine (`bind`)."""
        return self.active and self._pass is not None

    # -- the JAX context's per-leaf decisions ---------------------------- #
    def _leaf_wire_bits(self, leaf, dim):
        """Per-leaf, per-direction quantization `(qwz, qgz)` of the JAX
        context: a direction keeps its bits only when the quantized
        payload beats the wire it replaces (the forward against the
        leaf's own width, the backward against fp32)."""
        lbc = self.lbc
        if lbc is None or not leaf.dtype.is_floating_point:
            return 0, 0
        qwz = lbc.qwz_bits if (lbc.qwz_bits and quantized_gather_saves_bytes(
            tuple(leaf.shape), dim, leaf.dtype, lbc.qwz_bits,
            lbc.block_size)) else 0
        qgz = lbc.qgz_bits if (lbc.qgz_bits and quantized_gather_saves_bytes(
            tuple(leaf.shape), dim, torch.float32, lbc.qgz_bits,
            lbc.block_size)) else 0
        return qwz, qgz

    def plan_for(self, num_layers: int, params_per_layer: int) -> StreamPlan:
        return plan_layer_streaming(num_layers, params_per_layer,
                                    self.max_live_parameters,
                                    self.prefetch_bucket_size,
                                    self.prefetch_mode)

    # -- the engine's side ------------------------------------------------ #
    def attach(self, model, layout) -> List[tuple]:
        """Take the ranks' flat-buffer layout (partition.Stage3Layout,
        region 0 the non-layer leaves, region 1 + l layer l), plan the
        stream and return the [start, end) spans the engine casts a
        forward: the non-layer region, then one span a layer group."""
        self.layout = layout
        num_layers = len(layout.regions) - 1
        per_layer = sum(int(np.prod(leaf.shape)) for leaf in
                        layout.region_leaves(1))
        plan = self.plan_for(num_layers, per_layer)
        self.last_plan = plan
        self._log_plan(plan)
        g = plan.layers_per_step
        self.layer_regions = [
            (layout.regions[1 + i][0], layout.regions[i + g][1])
            for i in range(0, num_layers, g)]
        spans = [layout.regions[0]] + self.layer_regions
        self._spans = spans
        self._leaves = [[leaf for leaf in layout.leaves
                         if lo <= leaf.offset < hi] for lo, hi in spans]
        # a layer's leaves by their names in the layer module
        self._layer_names = [leaf.name.split(".", 2)[2]
                             for leaf in layout.region_leaves(1)]
        self._call = _Call(model)
        return spans

    def _log_plan(self, plan):
        if plan.forfeited:
            from ..resilience.degradation import record as degrade
            degrade("zero3_prefetch", "overlapped", "serialized",
                    plan.forfeited)
        lb = ""
        if self.lbc is not None:
            hpz = (sorted(self.param_manual)
                   if self.lbc.hpz_group_size > 1 else "off")
            lb = (f", low_bandwidth: qwz={self.lbc.qwz_bits}b "
                  f"qgz={self.lbc.qgz_bits}b hpz={hpz}"
                  f"{' fcm' if self.fcm else ''}")
        log_dist(
            f"ZeRO-3 streaming: {plan.num_layers} layers in groups of "
            f"{plan.layers_per_step}, prefetch={plan.prefetch} "
            f"(mode={plan.mode}), live<= {plan.live_parameters:,} "
            f"params (max_live={self.max_live_parameters:,}){lb}",
            ranks=[0])
        if plan.forfeited:
            log_dist(
                f"ZeRO-3 streaming: prefetch FORFEITED — "
                f"{plan.forfeited}; falling back to serialized "
                f"at-use gathers ({plan.num_layers} layers in groups "
                f"of {plan.layers_per_step})",
                ranks=[0], level=logging.WARNING)

    @contextmanager
    def bind(self, regions):
        """The engine's forward: `regions[i]` holds local rank i's
        compute-dtype shards, one 1-D tensor a span of `attach`.  The
        non-layer leaves are gathered here."""
        run = _Pass(self, regions)
        fulls = _GatherGroup.apply(run, 0, False, *run.group_regions(0))
        k = len(self._leaves[0])
        run.nonlayer = [
            {"model." + leaf.name: fulls[i * k + j]
             for j, leaf in enumerate(self._leaves[0])}
            for i in range(len(regions))]
        self._pass = run
        try:
            yield run
        finally:
            # the gathered non-layer leaves' grad_fn holds `run`: keeping
            # them on it would make a cycle through the autograd graph,
            # which the garbage collector cannot free
            run.nonlayer = None
            self._pass = None

    # -- the model's side ------------------------------------------------- #
    def _device(self, j):
        """Local rank j's card made the current device (the kernel wrappers
        launch on it only; the caller's stream of each card runs its
        ranks' work)."""
        dev = self.ctx.device_of(self.ctx.local_ranks[j])
        return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()

    def call(self, index, fn, *args):
        """`fn(*args)`, a method of the model, on local rank `index`'s
        gathered non-layer leaves."""
        with self._device(index):
            return functional_call(self._call, self._pass.nonlayer[index],
                                   (fn,) + args)

    def scan(self, layers, hs, generators, deterministic, remat=False):
        """Every local rank's hidden states `hs` through the layer stack
        in group lockstep, as the plan says; returns them, rank by rank.
        `remat`: each layer is recomputed in the backward (`_RematLayer`)."""
        self._layers = layers
        self._remat = bool(remat)
        run = self._pass
        steps = len(self.layer_regions)
        if self.last_plan.mode == "carried":
            tensors = list(hs) + [t for i in range(steps)
                                  for t in run.group_regions(1 + i)]
            return list(_CarriedStream.apply(run, list(generators),
                                             deterministic, *tensors))
        prefetch = self.last_plan.prefetch
        hs = list(hs)

        def gathered(i, asynchronous):
            flat = _GatherGroup.apply(run, 1 + i, asynchronous,
                                      *run.group_regions(1 + i))
            k = len(flat) // len(hs)
            fulls = [list(flat[j * k:(j + 1) * k]) for j in range(len(hs))]
            run.hold(1 + i, fulls)
            self._account(fulls, +1)
            return fulls

        nxt = gathered(0, False)
        for i in range(steps):
            cur = nxt
            if prefetch and i + 1 < steps:
                nxt = gathered(i + 1, True)
            self._wait(1 + i, run)
            with torch.autograd.graph.saved_tensors_hooks(run.pack,
                                                          run.unpack):
                hs = [self._run_group(i, j, h, cur[j], generators[j],
                                      deterministic)
                      for j, h in enumerate(hs)]
            run.drop(cur)
            self._account(cur, -1)
            del cur
            if not prefetch and i + 1 < steps:
                nxt = gathered(i + 1, False)
        return hs

    def _run_group(self, i, j, h, fulls, generator, deterministic,
                   replays=None, before_layer=None):
        """Layer group i on rank j's hidden states, from its gathered
        leaves (`fulls`, layer by layer in layout order).  Under remat
        with grad enabled each layer is a `_RematLayer`: its forward draws
        from `generator` and its recompute from `recompute_generator` of
        it, or both from `replays` (one pair a layer: the carried
        backward's).  `before_layer()` runs before each layer (the carried
        forward notes the generator's state there)."""
        names = self._layer_names
        k = len(names)
        g = self.last_plan.layers_per_step
        remat = self._remat and torch.is_grad_enabled()
        with self._device(j):
            for t in range(g):
                layer, params = self._layers[i * g + t], fulls[t * k:
                                                              (t + 1) * k]
                if before_layer is not None:
                    before_layer()
                if not remat:
                    h = functional_call(layer, dict(zip(names, params)),
                                        (h,), {"generator": generator,
                                               "deterministic": deterministic})
                    continue
                if replays is None:
                    gen, replay = generator, recompute_generator(generator)
                else:
                    gen, replay = replays[t][0](), replays[t][1]
                h = _RematLayer.apply(_LayerCall(self, layer, j, gen, replay,
                                                 deterministic), h, *params)
        return h

    # -- the wire --------------------------------------------------------- #
    def _account(self, fulls, sign):
        if fulls is None:
            return
        for j, rank in enumerate(fulls):
            if rank is not None:
                self._account_rank(j, rank, sign)

    def _account_rank(self, j, tensors, sign):
        self.live_bytes[j] += sign * sum(t.numel() * t.element_size()
                                         for t in tensors)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes[j])

    def _wait(self, g, run):
        """The current streams wait for group g's copies (a prefetch)."""
        events = run.pending.pop(g, None)
        if events is None:
            return
        for j, ev in enumerate(events):
            dev = self.ctx.device_of(self.ctx.local_ranks[j])
            torch.cuda.current_stream(dev).wait_event(ev)

    def _quantized(self, g) -> bool:
        return g > 0 and self.lbc is not None

    def _gather(self, g, regions, run=None, only=None):
        """Span g gathered for every local rank: [rank][leaf] tensors of
        the whole leaves in layout order (`only`: for that local rank
        alone, None in the others' places; counted by the caller).  With
        a forward's `run` given (a prefetch) the plain wire's copies go
        on the ranks' copy streams, after the work the current streams
        hold so far, and `_wait(g, run)` joins them."""
        if only is None:
            self.counts["gathers"] += 1
        if self._quantized(g):
            out = self._gather_quantized(g, regions)
            return out if only is None else [
                rank if j == only else None for j, rank in enumerate(out)]
        lo = self._spans[g][0]
        mesh = self.ctx
        ranks = mesh.local_ranks
        async_ = run is not None and mesh.is_cuda
        out = []
        for j, r in enumerate(ranks):
            if only is not None and j != only:
                out.append(None)
                continue
            dev = mesh.device_of(r)
            fulls = []
            for leaf in self._leaves[g]:
                o = leaf.offset - lo
                if leaf.dim is None:
                    fulls.append(regions[j][o:o + leaf.numel]
                                 .view(leaf.piece_shape).clone())
                else:
                    fulls.append(torch.empty(leaf.shape,
                                             dtype=regions[j].dtype,
                                             device=dev))
            out.append(fulls)
        if async_:
            ready = {}
            for r in ranks:
                dev = mesh.device_of(r)
                if dev not in ready:
                    ready[dev] = torch.cuda.Event()
                    ready[dev].record(torch.cuda.current_stream(dev))
            events = []
        for j, r in enumerate(ranks):
            if out[j] is None:
                continue
            dev = mesh.device_of(r)
            ctx = (torch.cuda.stream(mesh._streams()[1][r]) if async_
                   else nullcontext())
            if async_:
                mesh._streams()[1][r].wait_event(ready[dev])
            with ctx:
                for leaf, full in zip(self._leaves[g], out[j]):
                    if leaf.dim is None:
                        continue
                    o = leaf.offset - lo
                    pieces = [reg[o:o + leaf.numel].view(leaf.piece_shape)
                              for reg in regions]
                    pieces = [p if p.device == dev else p.to(dev)
                              for p in pieces]
                    torch.cat(pieces, dim=leaf.dim, out=full)
            if async_:
                ev = torch.cuda.Event()
                ev.record(mesh._streams()[1][r])
                events.append(ev)
        if async_:
            run.pending[g] = events
        return out

    def _scatter(self, g, grads):
        """The transpose of `_gather(g)`: grads[j][k], rank j's gradient of
        leaf k (None: zero), reduce-scattered into each owner's shard of
        span g (one 1-D compute-dtype tensor a rank)."""
        self.counts["scatters"] += 1
        if self._quantized(g):
            return self._scatter_quantized(g, grads)
        lo, hi = self._spans[g]
        mesh = self.ctx
        ranks = mesh.local_ranks
        w = len(ranks)
        tables = []
        dtype = None
        for j, r in enumerate(ranks):
            dev = mesh.device_of(r)
            table = torch.empty(w, hi - lo, dtype=torch.float32, device=dev)
            for leaf, gk in zip(self._leaves[g], grads[j]):
                o = leaf.offset - lo
                if gk is not None:
                    dtype = gk.dtype
                cols = table[:, o:o + leaf.numel]
                if leaf.dim is None or gk is None:
                    cols.zero_()
                    continue
                c = leaf.shape[leaf.dim] // w
                cols.view((w,) + leaf.piece_shape).copy_(
                    gk.unflatten(leaf.dim, (w, c)).movedim(leaf.dim, 0))
            tables.append(table)
        dtype = dtype or torch.float32
        out = []
        for j, r in enumerate(ranks):
            dev = mesh.device_of(r)
            total = tables[0][j].to(dev, copy=True)
            for t in tables[1:]:
                total.add_(t[j].to(dev))
            for leaf, gk in zip(self._leaves[g], grads[j]):
                if leaf.dim is None and gk is not None:
                    o = leaf.offset - lo
                    total[o:o + leaf.numel].copy_(gk.reshape(-1))
            out.append(total.to(dtype))
        return out

    # -- the low-bandwidth route ------------------------------------------ #
    def _kinds(self, g):
        """Span g's leaves by kind: [(position of the kind's leaf in each
        layer, ...)], layer-major layout order."""
        leaves = self._leaves[g]
        k = len(self._layer_names)
        layers = len(leaves) // k
        return [[t * k + m for t in range(layers)] for m in range(k)]

    def _stacked(self, g, regions, idx):
        lo = self._spans[g][0]
        leaves = self._leaves[g]
        return [torch.stack([reg[leaves[i].offset - lo:
                                 leaves[i].offset - lo + leaves[i].numel]
                             .view(leaves[i].piece_shape) for i in idx])
                for reg in regions]

    def _gather_leaf(self, xs, axes, dim):
        """One leaf's tiled all-gather (the JAX context's): a quantized
        wire per direction where it pays (`_leaf_wire_bits`), the per-tile
        ring transport for float leaves under fused_collective_matmul,
        the native gather otherwise.  `xs`: the ranks' pieces."""
        qwz, qgz = self._leaf_wire_bits(xs[0], dim)
        block = self.lbc.block_size
        if self.fcm and xs[0].is_floating_point():
            return fcm_all_gather(xs, axes, dim, qwz, qgz, block,
                                  mesh=self.ctx)
        if qwz or qgz:
            return low_bandwidth_all_gather(xs, axes, dim, qwz, qgz, block,
                                            mesh=self.ctx)
        return self.ctx.all_gather(xs, axes, dim)

    def _gather_quantized(self, g, regions):
        leaves = self._leaves[g]
        out = [[None] * len(leaves) for _ in regions]
        for idx in self._kinds(g):
            leaf = leaves[idx[0]]
            xs = self._stacked(g, regions, idx)
            if leaf.dim is None:
                fulls = [x.clone() for x in xs]
            else:
                with torch.no_grad():
                    fulls = self._gather_leaf(xs, self.axes, leaf.dim + 1)
            for j, full in enumerate(fulls):
                for t, i in enumerate(idx):
                    out[j][i] = full[t]
        return out

    def _scatter_quantized(self, g, grads):
        lo, hi = self._spans[g]
        leaves = self._leaves[g]
        block = self.lbc.block_size
        dtype = next(gk.dtype for rank in grads for gk in rank
                     if gk is not None)
        out = [torch.empty(hi - lo, dtype=dtype,
                           device=self.ctx.device_of(r))
               for r in self.ctx.local_ranks]
        for idx in self._kinds(g):
            leaf = leaves[idx[0]]
            gs = [torch.stack([rank[i] if rank[i] is not None else
                               torch.zeros(leaves[i].shape, dtype=dtype,
                                           device=out[j].device)
                               for i in idx]) for j, rank in enumerate(grads)]
            if leaf.dim is None:
                shards = gs
            else:
                dim = leaf.dim + 1
                piece = SimpleNamespace(
                    shape=(len(idx),) + leaf.piece_shape, dtype=dtype)
                _, qgz = self._leaf_wire_bits(piece, dim)
                if self.fcm:
                    shards = fcm_reduce_scatter(gs, self.axes, dim, bits=qgz,
                                                block=block, mesh=self.ctx)
                elif qgz:
                    shards = quantized_psum_scatter(gs, self.axes, dim,
                                                    bits=qgz, block=block,
                                                    mesh=self.ctx)
                else:
                    shards = f32_psum_scatter(gs, self.axes, dim,
                                              mesh=self.ctx)
            for j, shard in enumerate(shards):
                for t, i in enumerate(idx):
                    o = leaves[i].offset - lo
                    out[j][o:o + leaves[i].numel].copy_(
                        shard[t].reshape(-1))
        return out

