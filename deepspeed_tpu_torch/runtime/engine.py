"""DeepSpeedEngine: training on one device, on the data-parallel ranks
of a single-controller mesh, or on one rank a process of a torch.distributed
world (counterpart of deepspeed_tpu/runtime/engine.py).

What it keeps of the JAX engine:

- The mesh: the `mesh=` argument, else the registered mesh, else the
  config's "mesh" block (`resolve_mesh_ctx`), whose data axis defaults to
  -1, "fill the devices": every visible card for device None / "cuda",
  the one device of "cpu" or "cuda:k" (where a `data` of W puts W ranks).
  Under a torch.distributed world of P processes (`init_distributed`) the
  mesh holds one rank a process, on the process's card, and its data axis
  is P.  The config's batch arithmetic is checked at the data-parallel
  world W.  Every per-rank list below holds the ranks this process drives
  (`mesh.local_ranks`): all W under one controller, its own under P.
- fp32 master weights owned by the engine, replicated on every rank below
  ZeRO-3.  Rank r's live in ONE flat fp32 buffer on its device
  (`devices[r % n]`), every parameter a view into it, and their grads in a
  second flat buffer that autograd accumulates into, so the optimizer step
  is a few large elementwise ops (runtime/optimizers.py).  Both are
  zero-padded to a multiple of W; `engine.module`'s parameters are rank
  0's views.
- ZeRO stages 0-2 over the flat layout (runtime/zero/partition.py): stage
  1 shards the optimizer state over the ranks' ranges, stage 2 also
  reduce-scatters each micro-step's grads into the owner's range, where
  they accumulate; stage 1 sums the accumulated full grads at the
  boundary; stage 0 all-reduces them and every rank steps the whole
  buffer.  The sums run over the ranks in rank order and divide by W once,
  so stages 1 and 2 give the same bits.  After the step every rank's
  updated range is all-gathered into every rank's buffer.
- The batch (`_shard_batch`): this process's rows (the whole global
  batch under one controller; under P processes, the JAX engine's
  multi-host rule, this process's slice of it).  A leading dimension the
  local ranks divide is split into contiguous row blocks in rank order;
  anything else goes whole to every rank.
- The forward runs each rank on its own compute stream, on every floating
  parameter cast to the compute dtype, LayerNorm gamma/beta and the
  embeddings included (the JAX engine's `_tree_cast(p, compute_dtype)`
  inside `loss_fn`), through `torch.func.functional_call`; autograd
  returns fp32 grads to the rank's master, on the rank's stream.
  `bf16.grads_in_compute_dtype` accumulates the micro-steps' grads in bf16
  instead (bf16 only, as in the JAX engine).
- fp16 (`"fp16": {"enabled": true}`, the JAX engine's): the compute dtype
  is fp16, so every parameter is rounded through fp16, while the model
  computes in its own dtype (bf16 by default): LayerNorm's gamma and beta
  reach kernels A and D as fp16 vectors and every other use casts on.
  The loss is scaled by the dynamic scaler (`initial_scale_power`,
  `loss_scale_window`, `hysteresis`, `min_loss_scale`) or the static
  `loss_scale`; the grads that come back through the fp16 casts overflow
  to inf, the step's finite flag skips the update, and the scaler halves.
- `forward(*batch)` returns the unscaled loss with its graph, the mean of
  all W ranks' losses (the global batch's loss when the ranks hold equal
  token counts; under processes the W losses are gathered over the
  group); `backward(loss)` backpropagates loss * loss_scale, which
  gives each rank the grads of its own loss, and accumulates across
  micro-steps (the PyTorch idiom; the JAX engine fuses grad into forward).
- `step()` acts at the gradient-accumulation boundary: unscale by
  1 / (loss_scale * gas * W) in fp32, a finite flag over all ranks' grads
  (one rank's overflow skips the step on every rank, as the JAX engine's
  one `isfinite` over the grad tree), the optimizer update of each rank's
  range through a where(finite) select (a non-finite step leaves
  parameters and optimizer state, its count too, as they were), the loss
  scaler update, the LR scheduler's step.  It reads nothing back to the
  host: the overflow flag stays on the device (`overflow` reads it).
- A `torch.Generator` per rank on its device, seeded 42 + r for global
  rank r (the JAX engine's key is 42), so no two ranks draw the same
  dropout mask.
- Checkpoints in the JAX engine's consolidated layout, file for file
  (`save_checkpoint`, `load_checkpoint`; runtime/checkpoint.py): the
  module tree, the optax state tree that the JAX chain holds for the
  config (optimizers.py `jax_state`), the scaler, and the client state.
  A run moves between the packages in either direction.  The leaves are
  whole, so a load at any data-parallel world cuts them into its own
  ranges.  In place of the JAX key `engine_rng`, every rank's generator
  state is saved (TORCH_RNG_KEY, in global rank order), restored when the
  world is the same.  Under processes the ranges and generator states
  are gathered over the group, process 0 writes the files the single
  controller writes, and every process loads and cuts its own range.

What is not ported yet is refused by `refuse_unported` with the ROADMAP.md
item that will port it: among others the sharded checkpoint layout (A.5)
and the resilience block that would make saves atomic (A.6).
"""

import os

import numpy as np
import torch
from torch.func import functional_call

from .. import constants as C
from ..config import DeepSpeedConfig, MeshConfig
from ..config_utils import load_config_dict
from ..models.convert import gpt2_flat_from_tree, gpt2_tree_from_flat
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import ZERO_AXES, MeshContext
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import checkpoint as ckpt_mod
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import (LossScaleState, create_loss_scaler,
                               update_loss_scale)
from .lr_schedules import get_lr_schedule
from .optimizers import (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                         FlatOptimizer, build_optimizer)
from .resilience import reshard
from .zero.partition import ZeroPartitioner

FORWARD_MICRO_TIMER = "forward_microstep"
BACKWARD_MICRO_TIMER = "backward_microstep"
STEP_MICRO_TIMER = "step_microstep"
# client-state key of every rank's torch.Generator state (byte lists in
# rank order): the counterpart of the JAX engine's `engine_rng` key
TORCH_RNG_KEY = "torch_rng"

# the mesh axes the engine refuses above 1, with the items that port them
_UNPORTED_AXES = (("model", "tensor parallelism", "A.9"),
                  ("pipe", "pipeline parallelism", "A.9"),
                  ("seq", "sequence parallelism", "A.9"),
                  ("expert", "expert parallelism (MoE)", "A.10"))


def _refuse(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _refuse_mesh_axes(sizes, where):
    for axis, what, item in _UNPORTED_AXES:
        if sizes[axis] > 1:
            _refuse(f"{where}: a {axis} axis of {sizes[axis]} ({what})", item)


def _torch_distributed_world() -> int:
    world = mesh_mod.process_world()
    return 1 if world is None else world[0]


def _check_process_world(mesh: MeshContext) -> None:
    """The mesh must hold one rank for each process of the torch.distributed
    world it runs in (a mesh built before `init_distributed`, or by another
    world, does not)."""
    procs = _torch_distributed_world()
    if mesh.process_count != procs:
        raise ValueError(
            f"the mesh {mesh} drives its data axis of "
            f"{mesh.axis_size('data')} from {mesh.process_count} process(es), "
            f"which disagrees with the torch.distributed world of {procs} "
            "processes (one rank a process: build the mesh after "
            "init_distributed, with data equal to the process count)")


def resolve_mesh_ctx(config, mesh=None, device=None) -> MeshContext:
    """The engine's mesh, from (in order) the `mesh` argument, the
    registered mesh, or the config's "mesh" block on the devices `device`
    names (None or "cuda": every visible card, or under a torch.distributed
    world this process's card; "cpu" or "cuda:k": that one device);
    registered as the global mesh.  Only the mesh block is
    read before the mesh exists: the full config parse checks the batch
    arithmetic at the mesh's data-parallel world.  An explicit entry of
    the block that disagrees with a given or registered mesh raises."""
    raw = (config._param_dict if isinstance(config, DeepSpeedConfig)
           else load_config_dict(config))
    block = raw.get(C.MESH) or {}
    mesh_cfg = MeshConfig.from_dict(block)
    _refuse_mesh_axes(vars(mesh_cfg), "the config's mesh")
    device = torch.device("cuda" if device is None else device)
    if mesh is None:
        mesh = mesh_mod.get_mesh_context(required=False)
    if mesh is None:
        devices = (None if device.type == "cuda" and device.index is None
                   else [device])
        mesh = MeshContext.from_config(mesh_cfg, devices)
    else:
        if not isinstance(mesh, MeshContext):
            raise TypeError(f"mesh must be a MeshContext, got "
                            f"{type(mesh).__name__}")
        clash = {axis: size for axis, size in block.items()
                 if size != -1 and mesh.axis_sizes.get(axis) != size}
        if clash or mesh.devices[0].type != device.type:
            raise ValueError(
                f"the config's mesh block {block} and device {device} "
                f"disagree with the mesh in use, {mesh} (given as mesh= or "
                "registered by initialize_mesh or an earlier engine; call "
                "reset_mesh_context() to build the config's)")
    mesh_mod.set_mesh_context(mesh)
    return mesh


def refuse_unported(config: DeepSpeedConfig, model, mesh: MeshContext) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item that ports it,
    for every feature of the config, model or mesh that the port does not
    run yet."""
    from ..models.gpt2 import GPT2Model

    if not isinstance(model, GPT2Model):
        _refuse(f"training a {type(model).__name__} (only GPT2Model is "
                "ported; a PipelineModule is A.9, an MoE model A.10)",
                "A.9-A.10")
    _refuse_mesh_axes(mesh.axis_sizes, "the mesh")
    zc = config.zero_config
    if zc.stage >= 3:
        _refuse(f"zero_optimization.stage {zc.stage} (ZeRO-3)", "A.5")
    for what, off in (("offload_param", zc.offload_param),
                      ("offload_optimizer", zc.offload_optimizer)):
        if off is not None and off.device not in (None, "none"):
            _refuse(f"zero_optimization.{what} (the offload tier)", "A.7")
    if config.fused_step_config.enabled:
        _refuse("fused_step (one dispatch per optimizer step)", "A.6")
    if (config.optimizer_name or "").lower() in (ONEBIT_ADAM_OPTIMIZER,
                                                 ONEBIT_LAMB_OPTIMIZER):
        _refuse(f"the {config.optimizer_name} optimizer", "A.8")
    if zc.low_bandwidth.onebit:
        _refuse("zero_optimization.low_bandwidth.onebit (the 1-bit wire "
                "tier)", "A.8")
    if zc.low_bandwidth.enabled:
        _refuse("zero_optimization.low_bandwidth in the engine (the qwZ / qgZ "
                "ops and the fused collective-matmul are ported, "
                "runtime/comm/low_bandwidth.py and ops/collective_matmul.py; "
                "the engine uses them inside the streamed ZeRO-3 scan)", "A.5")
    if config.sequence_parallel_config.size > 1:
        _refuse("sequence parallelism", "A.9")
    flags = (("resilience", config.resilience_config.enabled, "A.6, A.13"),
             ("monitor", config.monitor_config.enabled, "A.6, A.13"),
             ("analysis", config.analysis_config.enabled, "A.14"),
             ("progressive_layer_drop", config.pld_enabled, "A.13"),
             ("curriculum_learning", config.curriculum_enabled, "A.13"),
             ("quantize_training", config.quantize_training_enabled, "A.13"),
             ("eigenvalue", config.eigenvalue_config.enabled, "A.13"),
             ("sparse_gradients", config.sparse_gradients_enabled, "A.13"),
             ("flops_profiler", config.flops_profiler_config.enabled, "A.13"),
             ("tensorboard", config.tensorboard_config.enabled, "A.13"))
    for what, on, item in flags:
        if on:
            _refuse(f"the {what} block", item)


class _MeanOfRanks(torch.autograd.Function):
    """The mean of `stacked`, every rank's loss in rank order (detached),
    with `losses`, this process's ranks' losses, as the inputs that carry
    the graph.  Its backward hands every local rank's loss the incoming
    gradient unchanged: each rank backpropagates its own loss, as data
    parallelism does, and the engine divides the gradients summed over
    the ranks by their number."""

    @staticmethod
    def forward(ctx, stacked, *losses):
        ctx.devices = [loss.device for loss in losses]
        return stacked.mean()

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad.to(d) for d in ctx.devices))


class DeepSpeedEngine:
    """Config-driven training engine over the data-parallel ranks of a
    mesh (one rank on one device by default)."""

    def __init__(self, model=None, config=None, optimizer=None,
                 model_parameters=None, lr_scheduler=None,
                 training_data=None, collate_fn=None, device="cuda",
                 mesh=None):
        self.module = model
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.mesh = resolve_mesh_ctx(config, mesh, device)
        _check_process_world(self.mesh)
        world = self.mesh.data_parallel_world_size
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, world_size=world))
        self.world_size = world
        # the ranks this process drives: every rank under one controller,
        # its own under a process world
        self.local_ranks = list(self.mesh.local_ranks)
        refuse_unported(self.config, model, self.mesh)
        self.device = self.mesh.device_of(self.local_ranks[0])
        self.zero_partitioner = ZeroPartitioner(
            self.mesh, self.config.zero_optimization_stage,
            self.config.zero_config.param_persistence_threshold)

        # the JAX engine's precision: bf16 first, then fp16 (every floating
        # parameter rounded through fp16 on its way to the model, which
        # computes in its own dtype), else fp32
        if self.config.bf16.enabled:
            self.compute_dtype = torch.bfloat16
        elif self.config.fp16.enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.scaler_cfg, self.scaler_state = create_loss_scaler(
            self.config.fp16 if self.config.fp16.enabled else None,
            device=self.device)
        self._grads_half = (self.config.bf16.enabled
                            and self.config.bf16.grads_in_compute_dtype)

        # ---- fp32 master weights: a flat buffer a rank, params views ---- #
        if model_parameters is not None:
            model.load_state_dict(model_parameters)
        self._named_params = list(model.named_parameters())
        self._segments = []
        off = 0
        for _, p in self._named_params:
            self._segments.append((off, p.numel()))
            off += p.numel()
        self.num_params = off
        padded = self.zero_partitioner.padded_size(off)
        self._flats, self._flat_grads, self._leaves = [], [], []
        with torch.no_grad():
            for i, r in enumerate(self.local_ranks):
                dev = self.mesh.device_of(r)
                flat = torch.zeros(padded, dtype=torch.float32, device=dev)
                grad = torch.zeros_like(flat)
                leaves = {}
                for (name, p), (o, n) in zip(self._named_params,
                                             self._segments):
                    view = flat[o:o + n].view(p.shape)
                    view.copy_(p.detach())
                    if i == 0:  # the module's own parameters
                        p.data = view
                        leaf = p
                    else:
                        leaf = view
                    leaf.requires_grad_(True)
                    leaf.grad = grad[o:o + n].view(p.shape)
                    leaves[name] = leaf
                self._flats.append(flat)
                self._flat_grads.append(grad)
                self._leaves.append(leaves)
        self._flat, self._flat_grad = self._flats[0], self._flat_grads[0]
        self._ranges = [self.zero_partitioner.owned_range(off, r)
                        for r in self.local_ranks]
        # stage 2 on several ranks: each micro-step's grads are
        # reduce-scattered into the rank's range and accumulate there
        self._scatter_each_micro = self.zero_partitioner.stage >= 2 \
            and world > 1
        acc_dtype = self.compute_dtype if self._grads_half else torch.float32
        self._acc = [torch.zeros(hi - lo, dtype=acc_dtype,
                                 device=self.mesh.device_of(r))
                     if self._scatter_each_micro else None
                     for r, (lo, hi) in zip(self.local_ranks, self._ranges)]

        # ---- LR schedule + optimizer --------------------------------- #
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        if optimizer is not None:
            if not isinstance(optimizer, FlatOptimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch FlatOptimizer "
                    "(runtime.optimizers.build_optimizer), got "
                    f"{type(optimizer).__name__}")
            self.optimizer = optimizer
        else:
            self.optimizer = build_optimizer(
                self.config.optimizer_name or "adam",
                self.config.optimizer_params,
                learning_rate=self.lr_scheduler,
                gradient_clipping=self.config.gradient_clipping)
        # the parameters' places in the flat buffer are the engine's, and
        # the layers' copies of a parameter share the JAX tree's leaf
        leaves = {}
        self.optimizer.segments = self._segments
        self.optimizer.segment_leaves = [
            leaves.setdefault(model.jax_leaf(name), len(leaves))
            for name, _ in self._named_params]
        self.opt_states = [self.optimizer.init(flat[lo:hi]) for flat, (lo, hi)
                           in zip(self._flats, self._ranges)]
        self.opt_state = self.opt_states[0]

        self.training_dataloader = self._configure_dataloader(
            training_data, collate_fn)
        self._rngs = [torch.Generator(device=self.mesh.device_of(r))
                      .manual_seed(42 + r) for r in self.local_ranks]

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.world_size,
            steps_per_output=self.steps_per_print())
        self._last_loss = None
        self._rank_losses = None
        self._last_overflow = None
        self._is_train_mode = True
        log_dist(f"DeepSpeedEngine: zero_stage="
                 f"{self.zero_optimization_stage()} dtype={self.compute_dtype} "
                 f"mesh={self.mesh} dp_world={world} params={off} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # configuration accessors (reference: engine.py:260-540)
    # ------------------------------------------------------------------ #
    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def steps_per_print(self):
        return self.config.steps_per_print

    def zero_optimization(self):
        return self.config.zero_enabled

    def zero_optimization_stage(self):
        return self.config.zero_optimization_stage

    def gradient_clipping(self):
        return self.config.gradient_clipping

    def fp16_enabled(self):
        return self.config.fp16.enabled

    def bfloat16_enabled(self):
        return self.config.bf16.enabled

    def wall_clock_breakdown(self):
        return self.config.wall_clock_breakdown

    def dynamic_loss_scale(self):
        return self.scaler_cfg.dynamic

    @property
    def loss_scale(self):
        return float(self.scaler_state.loss_scale)

    def get_lr(self):
        if self.lr_scheduler is not None:
            return [float(self.lr_scheduler.lr_at(self.opt_state["count"]))]
        return [float(self.config.optimizer_params.get("lr", 1e-3))]

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def train(self, mode: bool = True):
        self._is_train_mode = mode
        return self

    def eval(self):
        return self.train(False)

    @property
    def overflow(self) -> bool:
        """Whether the last step's grads were not finite (reads the device
        flag: a host synchronisation)."""
        return self._last_overflow is not None and bool(self._last_overflow)

    def was_step_applied(self) -> bool:
        return not self.overflow

    def module_state_dict(self):
        return self.module.state_dict()

    # ------------------------------------------------------------------ #
    # checkpoints in the JAX layout (reference: engine.py:2447-2895)
    # ------------------------------------------------------------------ #
    def _named_shapes(self):
        return [(name, tuple(p.shape)) for name, p in self._named_params]

    def _module_tree(self):
        """The parameters as the JAX tree (fp32 numpy), from the first
        local rank's buffer (every rank holds them whole)."""
        flat = self._flats[0][:self.num_params].detach().cpu().numpy()
        return gpt2_tree_from_flat(flat, self._named_shapes(),
                                   self.module.config)

    def _gathered(self, key):
        """Optimizer state `key` over the whole buffer: every rank's range
        in its place (at stage 0 each rank holds it all; under processes
        the ranges are all-gathered over the group, so every process must
        call it)."""
        if self.mesh.process_group is not None and \
                self.zero_partitioner.stage >= 1:
            with self.mesh.forked():
                full = self.mesh.all_gather_flat(
                    [state[key] for state in self.opt_states])[0]
            return full.cpu().numpy()
        full = np.empty(self._flats[0].numel(), dtype=np.float32)
        done = set()
        for (lo, hi), state in zip(self._ranges, self.opt_states):
            if (lo, hi) not in done:
                full[lo:hi] = state[key].detach().cpu().numpy()
                done.add((lo, hi))
        return full

    def _generator_states(self):
        """Every rank's generator state in global rank order (gathered
        from the processes under a process world)."""
        states = [g.get_state().tolist() for g in self._rngs]
        if self.mesh.process_group is None:
            return states
        import torch.distributed as dist
        every = [None] * self.mesh.process_count
        dist.all_gather_object(every, states, group=self.mesh.process_group)
        return [s for process in every for s in process]

    @property
    def _scheduled(self) -> bool:
        return hasattr(self.optimizer.lr, "lr_at")

    def _engine_state(self):
        """{"optimizer": the optax state tree the JAX engine holds for
        this config, "scaler": the loss scaler's state}, as numpy."""
        shapes, cfg = self._named_shapes(), self.module.config
        leaves = {key: gpt2_tree_from_flat(self._gathered(key), shapes, cfg)
                  for key in self.opt_state if key != "count"}
        count = self.opt_state["count"].detach().cpu().numpy()
        return {"optimizer": self.optimizer.jax_state(leaves, count,
                                                      self._scheduled),
                "scaler": LossScaleState(*(t.detach().cpu().numpy()
                                           for t in self.scaler_state))}

    def _partition_topology(self):
        """The partition topology every checkpoint records (reshard.py)."""
        topo = self.zero_partitioner.topology()
        topo.update({"format_version": reshard.TOPOLOGY_FORMAT_VERSION,
                     "process_count": self.mesh.process_count,
                     "layout": "consolidated"})
        return topo

    @staticmethod
    def _check_tag(tag):
        """'.tmp.' and '.old.' name the atomic protocol's working
        directories (resilience/atomic.py): such a tag would be invisible
        to tag discovery.  (Every process names the same tag: the default
        is the step count, which the processes share.)"""
        if ".tmp." in str(tag) or ".old." in str(tag):
            raise ValueError(
                f"checkpoint tag {tag!r} contains a reserved marker ('.tmp.' "
                "/ '.old.' name in-flight checkpoint dirs); pick another tag")

    def _refuse_sharded(self):
        if self.config.checkpoint_config.sharded:
            _refuse("checkpoint.sharded: true (the per-process sharded "
                    "checkpoint layout, runtime/sharded_checkpoint.py)", "A.5")

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write the JAX engine's consolidated layout under
        <save_dir>/<tag>/ (tag default: global_step<N>): the module tree,
        the optimizer and scaler state, and the client state with the
        engine's counters, the LR schedule, the batch triple, the
        data-parallel world, the partition topology and every rank's
        generator state (TORCH_RNG_KEY).  `latest` always moves to the
        tag: as in the JAX engine's consolidated layout, `save_latest` is
        not honoured (ROADMAP.md C).  Under a process world every process
        calls it: the state is gathered over the group, process 0 writes
        (the JAX engine's processes all write the same files) and the
        others wait for it.  Returns the tag's directory."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        self._check_tag(tag)
        self._refuse_sharded()
        client = dict(client_state or {})
        sched = self.lr_scheduler
        client.update({
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": (sched.state_dict()
                             if hasattr(sched, "state_dict") else None),
            "ds_config_batch": [self.train_batch_size(),
                                self.train_micro_batch_size_per_gpu(),
                                self.gradient_accumulation_steps()],
            "dp_world_size": self.world_size,
            # MoQ and curriculum learning are refused (A.13)
            "quantizer": None,
            "curriculum": None,
            TORCH_RNG_KEY: self._generator_states(),
            reshard.TOPOLOGY_KEY: self._partition_topology(),
        })
        module_state = {"module": self._module_tree()}
        optimizer_state = self._engine_state()
        path = os.path.join(save_dir, str(tag))
        if self._writes_files:
            path = ckpt_mod.save_checkpoint_state(
                save_dir, tag, module_state=module_state,
                optimizer_state=optimizer_state, client_state=client)
        self._wait_for_writer()
        log_dist(f"saved checkpoint {path}", ranks=[0])
        return path

    @property
    def _writes_files(self) -> bool:
        """Process 0 writes a checkpoint (the only process under one
        controller)."""
        return self.local_ranks[0] == 0

    def _wait_for_writer(self):
        """Under a process world, every process waits until process 0's
        files are written."""
        if self.mesh.process_group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.mesh.process_group)

    def _set_full(self, buffers, full):
        """Copy a full padded fp32 vector into each local rank's range of
        `buffers` (one tensor a rank, covering its range)."""
        full = torch.from_numpy(full)
        for (lo, hi), buf in zip(self._ranges, buffers):
            part = full if buf.numel() == full.numel() else full[lo:hi]
            buf.copy_(part.to(buf.device))

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Load a checkpoint of either package's consolidated layout (tag
        None: the one `latest` names) at this engine's data-parallel world,
        whatever the world it was saved at: the topology is checked first
        (reshard.check_reshard), the module tree goes into every rank's
        buffer, the optimizer state is cut into this engine's ranges.  The
        scaler, the LR schedule's state, the counters and (when the saved
        world equals this one) every rank's generator are restored.
        Returns (the tag's directory, the client state)."""
        resolved = tag or ckpt_mod.read_latest_tag(load_dir)
        saved_client = reshard.read_saved_client_state(load_dir,
                                                       str(resolved))
        reshard.check_reshard(str(resolved), saved_client,
                              self._partition_topology(),
                              current_world_size=self.world_size)
        if os.path.isfile(os.path.join(load_dir, str(resolved),
                                       "model_index.json")):
            _refuse("loading the sharded checkpoint layout", "A.5")
        opt_tmpl = (None if load_module_only or not load_optimizer_states
                    else self._engine_state())
        module_state, opt_state, client = ckpt_mod.load_checkpoint_state(
            load_dir, resolved, {"module": self._module_tree()}, opt_tmpl,
            strict=load_module_strict)
        shapes, cfg = self._named_shapes(), self.module.config
        padded = self._flats[0].numel()
        self._set_full(self._flats, gpt2_flat_from_tree(
            module_state["module"], shapes, cfg, padded))
        if opt_state is not None:
            leaves, count = self.optimizer.from_jax_state(
                opt_state["optimizer"], self._scheduled)
            if count is None:  # optax's SGD without a schedule keeps none
                count = (client.get("global_steps", 0)
                         - client.get("skipped_steps", 0))
            for key, tree in leaves.items():
                self._set_full([s[key] for s in self.opt_states],
                               gpt2_flat_from_tree(tree, shapes, cfg, padded))
            for state in self.opt_states:
                state["count"].fill_(int(count))
            self.scaler_state = LossScaleState(
                *(torch.from_numpy(np.array(v)).to(self.device)
                  for v in opt_state["scaler"]))
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and client.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(client["lr_scheduler"])
        if not load_module_only:
            self.global_steps = client.get("global_steps", 0)
            self.micro_steps = client.get("micro_steps", 0)
            self.skipped_steps = client.get("skipped_steps", 0)
            self._load_generators(client.get(TORCH_RNG_KEY))
        for i, grad in enumerate(self._flat_grads):
            grad.zero_()
            if self._scatter_each_micro:
                self._acc[i].zero_()
            else:
                self._acc[i] = None
        self._last_loss = self._rank_losses = self._last_overflow = None
        path = os.path.join(load_dir, str(resolved))
        log_dist(f"loaded checkpoint {path}", ranks=[0])
        return path, client

    def _load_generators(self, saved):
        """Every local rank's generator from the saved states (global rank
        order), when there is one a rank of this engine's world and each
        fits its generator (a checkpoint of the JAX engine holds a JAX key
        instead, which is logged)."""
        current = [g.get_state() for g in self._rngs]
        if saved is None or len(saved) != self.world_size or any(
                len(saved[r]) != c.numel()
                for r, c in zip(self.local_ranks, current)):
            log_dist("generator states not restored: the checkpoint holds "
                     f"{'none' if saved is None else len(saved)} for "
                     f"{self.world_size} ranks of this engine (dropout draws "
                     "continue from the engine's seeds)", ranks=[0])
            return
        for g, r in zip(self._rngs, self.local_ranks):
            g.set_state(torch.tensor(saved[r], dtype=torch.uint8))

    @torch.no_grad()
    def load_module_state_dict(self, state_dict, strict=True):
        """Copy a module state dict (the port's parameter names, as
        `module_state_dict` returns) into every rank's fp32 master."""
        names = [name for name, _ in self._named_params]
        missing = [n for n in names if n not in state_dict]
        unexpected = [k for k in state_dict if k not in self._leaves[0]]
        if strict and (missing or unexpected):
            raise KeyError(f"state dict mismatch: missing {missing[:5]}, "
                           f"unexpected {unexpected[:5]}")
        for leaves in self._leaves:
            for name in names:
                if name in state_dict:
                    leaves[name].copy_(torch.as_tensor(state_dict[name]))

    def save_fp16_model(self, save_dir, save_filename="model_weights.npz"):
        """The module's weights in fp16, one .npz keyed by the JAX tree's
        paths (the JAX engine's export for serving).  Returns its path."""
        path = os.path.join(save_dir, save_filename)
        arrays = {name: arr.astype(np.float16)
                  if np.issubdtype(arr.dtype, np.floating) else arr
                  for name, arr in ckpt_mod.flatten(
                      self._module_tree()).items()}
        if self._writes_files:
            os.makedirs(save_dir, exist_ok=True)
            np.savez(path, **arrays)
        self._wait_for_writer()
        log_dist(f"saved {len(arrays)} half-precision weight arrays to "
                 f"{path}", ranks=[0])
        return path

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #
    def _configure_lr_scheduler(self, client_sched):
        if client_sched is not None:
            if not hasattr(client_sched, "lr_at"):
                raise TypeError("lr_scheduler must expose lr_at(step) -> lr "
                                "(evaluated on the optimizer's step count)")
            return client_sched
        if self.config.scheduler_name is not None:
            return get_lr_schedule(self.config.scheduler_name,
                                   self.config.scheduler_params)
        return None

    def _configure_dataloader(self, training_data, collate_fn):
        """This process's loader: micro-batch x its ranks' rows a batch,
        strided over the processes (the JAX engine's per-process shard)."""
        if training_data is None:
            return None
        return DeepSpeedDataLoader(
            training_data, batch_size=self.train_micro_batch_size_per_gpu()
            * len(self.local_ranks), collate_fn=collate_fn,
            data_parallel_world_size=self.mesh.process_count,
            data_parallel_rank=self.local_ranks[0] // len(self.local_ranks))

    def _shard_batch(self, value):
        """One value a local rank (JAX engine `_shard_batch`): `value` is
        this process's rows; a tensor or array whose leading dimension the
        local ranks divide is split into that many contiguous row blocks
        in rank order; anything else goes whole to every rank."""
        n = len(self.local_ranks)
        if isinstance(value, (torch.Tensor, np.ndarray)) and value.ndim >= 1 \
                and value.shape[0] % n == 0:
            rows = value.shape[0] // n
            return [value[i * rows:(i + 1) * rows] for i in range(n)]
        return [value] * n

    def _place(self, value, rank):
        dev = self.mesh.device_of(rank)
        if isinstance(value, torch.Tensor):
            return value.to(dev)
        if isinstance(value, np.ndarray):
            return torch.from_numpy(value).to(dev)
        return value

    # ------------------------------------------------------------------ #
    # forward / backward / step (reference: engine.py:1224,1303,1462)
    # ------------------------------------------------------------------ #
    def forward(self, *args, **kwargs):
        """The model's loss on this process's rows, each local rank's rows
        on its own stream and on every parameter cast to the compute
        dtype; dropout draws from the rank's generator.  Returns the
        unscaled loss with its autograd graph: the mean of all W ranks'
        losses, on the first local rank's device."""
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).start()
        if self._is_train_mode:
            self.tput_timer.start()
        args = [self._shard_batch(a) for a in args]
        kwargs = {k: self._shard_batch(v) for k, v in kwargs.items()}
        losses = []
        with self.mesh.forked():
            for i, (r, leaves) in enumerate(zip(self.local_ranks,
                                                self._leaves)):
                with self.mesh.rank(r):
                    cast = {name: p.to(self.compute_dtype)
                            if p.is_floating_point() else p
                            for name, p in leaves.items()}
                    losses.append(functional_call(
                        self.module, cast,
                        tuple(self._place(a[i], r) for a in args),
                        {**{k: self._place(v[i], r)
                            for k, v in kwargs.items()},
                         "generator": self._rngs[i]}))
            if self.world_size > 1 and self.mesh.process_group is not None:
                stacked = self.mesh.all_gather_flat(
                    [loss.detach().reshape(1) for loss in losses])[0]
        self._rank_losses = losses
        if self.world_size == 1:
            loss = losses[0]
        else:
            if self.mesh.process_group is None:
                stacked = torch.stack([loss.detach().to(self.device)
                                       for loss in losses])
            loss = _MeanOfRanks.apply(stacked, *losses)
        self._last_loss = loss
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Backpropagate loss * loss_scale (each rank's backward on its own
        stream), then accumulate the grads across micro-steps: at stage 2
        on several ranks in each rank's range (a reduce-scatter), else in
        the full buffers."""
        loss = self._last_loss if loss is None else loss
        if loss is None:
            raise RuntimeError("backward() called before forward()")
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).start()
        (loss.float() * self.scaler_state.loss_scale).backward()
        if self._scatter_each_micro:
            with self.mesh.forked():
                parts = self.mesh.reduce_scatter_flat(self._flat_grads,
                                                      ZERO_AXES)
                for i, (r, part) in enumerate(zip(self.local_ranks, parts)):
                    with self.mesh.rank(r):
                        self._acc[i].add_(part)
                        self._flat_grads[i].zero_()
        elif self._grads_half:
            with self.mesh.forked():
                for i, (r, grad) in enumerate(zip(self.local_ranks,
                                                  self._flat_grads)):
                    with self.mesh.rank(r):
                        half = grad.to(self.compute_dtype)
                        self._acc[i] = (half if self._acc[i] is None
                                        else self._acc[i] + half)
                        grad.zero_()
        self.micro_steps += 1
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).stop()
        return loss

    def _reduced_grads(self):
        """Each rank's summed (not yet unscaled) fp32 grads of the buffer
        it steps: its range, or at stage 0 the whole buffer."""
        if self._scatter_each_micro:
            return [acc.float() for acc in self._acc]
        full = [grad if acc is None else acc.float()
                for acc, grad in zip(self._acc, self._flat_grads)]
        if self.world_size == 1:
            return full
        parts = self.mesh.reduce_scatter_flat(full, ZERO_AXES)
        if self.zero_partitioner.stage == 0:
            return self.mesh.all_gather_flat(parts, ZERO_AXES,
                                             out=self._flat_grads)
        return parts

    def step(self, lr_kwargs=None):
        """Apply the optimizer at gradient-accumulation boundaries, each
        rank to the range it owns, then all-gather the ranges; no host
        synchronisation."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).start()
        if self._grads_half and not self._scatter_each_micro \
                and self._acc[0] is None:
            raise RuntimeError("step() called before backward()")
        mesh, world, local = self.mesh, self.world_size, self.local_ranks
        partitioned = self.zero_partitioner.stage >= 1 and world > 1
        inv = 1.0 / (self.scaler_state.loss_scale
                     * self.gradient_accumulation_steps() * world)
        with mesh.forked():
            grads = self._reduced_grads()
            flags = []
            for i, r in enumerate(local):
                with mesh.rank(r):
                    grads[i] = grads[i] * inv.to(mesh.device_of(r))
                    flags.append(torch.isfinite(grads[i]).all().reshape(1))
            flags = mesh.all_gather_flat(flags, ZERO_AXES)
            finite = []
            for i, r in enumerate(local):
                with mesh.rank(r):
                    finite.append(flags[i].all())
            params = [flat[lo:hi]
                      for flat, (lo, hi) in zip(self._flats, self._ranges)]
            self.optimizer.step_ranks(
                params, grads, self.opt_states, finite,
                offsets=[lo for lo, _ in self._ranges],
                rank=lambda i: mesh.rank(local[i]),
                total=((lambda parts: mesh.all_sum(parts, ZERO_AXES))
                       if partitioned else None))
            if partitioned:
                mesh.all_gather_flat(params, ZERO_AXES, out=self._flats)
            for i, r in enumerate(local):
                with mesh.rank(r):
                    self._flat_grads[i].zero_()
                    if self._scatter_each_micro:
                        self._acc[i].zero_()
                    else:
                        self._acc[i] = None
        overflow = ~finite[0]
        self.scaler_state = update_loss_scale(self.scaler_cfg,
                                              self.scaler_state, overflow)
        self._last_overflow = overflow
        self.global_steps += 1
        # the dynamic scaler (fp16) reads the flag, once a step, to count a
        # skipped step and hold the scheduler, as the JAX engine; bf16 /
        # fp32 and fp16's static scale never do
        if self.scaler_cfg.dynamic and bool(overflow):
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        self.tput_timer.stop(global_step=True)
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).stop()

    def estimate_memory(self):
        """Bytes a rank holds (the JAX engine's estimate, through the
        partitioner)."""
        return self.zero_partitioner.estimate_memory(self.num_params)

    def train_batch(self, data_iter=None):
        """gradient_accumulation_steps micro-steps and one optimizer step;
        returns the mean loss, read once after the whole window."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs data_iter or training_data")
            data_iter = iter(self.training_dataloader)
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = next(data_iter)
            if not isinstance(batch, tuple):
                batch = (batch,)
            loss = self.forward(*batch)
            self.backward(loss)
            self.step()
            losses.append(loss.detach())
        return float(torch.stack(losses).float().mean())
