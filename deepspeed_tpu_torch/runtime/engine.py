"""DeepSpeedEngine: single-GPU training (counterpart of
deepspeed_tpu/runtime/engine.py).

What it keeps of the JAX engine:

- fp32 master weights owned by the engine.  They live in ONE flat fp32
  buffer on the device, every parameter of the model a view into it, and
  their grads in a second flat buffer that autograd accumulates into, so
  the optimizer step is a few large elementwise ops (runtime/optimizers.py).
- The forward runs on every floating parameter cast to the compute dtype,
  LayerNorm gamma/beta and the embeddings included (the JAX engine's
  `_tree_cast(p, compute_dtype)` inside `loss_fn`), through
  `torch.func.functional_call`; autograd returns fp32 grads to the master.
  `bf16.grads_in_compute_dtype` accumulates the micro-steps' grads in bf16
  instead.
- `forward(*batch)` returns the unscaled loss with its graph;
  `backward(loss)` backpropagates loss * loss_scale and accumulates across
  micro-steps (the PyTorch idiom; the JAX engine fuses grad into forward).
- `step()` acts at the gradient-accumulation boundary: unscale by
  1 / (loss_scale * gas) in fp32, a finite flag over all grads, the
  optimizer update through a where(finite) select (a non-finite step leaves
  parameters and optimizer state, its count too, as they were), the loss
  scaler update, the LR scheduler's step.  It reads nothing back to the
  host: the overflow flag stays on the device (`overflow` reads it).
- One engine `torch.Generator` on the device, seeded 42 as the JAX engine's
  key; every forward draws its dropout from it.

ZeRO stages 0-2 are accepted and, at data-parallel world 1, partition
nothing.  What is not ported yet is refused by `refuse_unported` with the
ROADMAP.md item that will port it.
"""

import numpy as np
import torch
from torch.func import functional_call

from ..config import DeepSpeedConfig
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import create_loss_scaler, update_loss_scale
from .lr_schedules import get_lr_schedule
from .optimizers import (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                         FlatOptimizer, build_optimizer)

FORWARD_MICRO_TIMER = "forward_microstep"
BACKWARD_MICRO_TIMER = "backward_microstep"
STEP_MICRO_TIMER = "step_microstep"


def _data_parallel_world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def refuse_unported(config: DeepSpeedConfig, model) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item that ports it,
    for every feature of the config or model that the port does not run
    yet."""
    from ..models.gpt2 import GPT2Model

    def refuse(what, item):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                                  f"{item})")

    if not isinstance(model, GPT2Model):
        refuse(f"training a {type(model).__name__} (only GPT2Model is "
               "ported; a PipelineModule is A.9, an MoE model A.10)",
               "A.9-A.10")
    world = _data_parallel_world()
    mesh = config.mesh_config
    if world > 1 or max(mesh.model, mesh.pipe, mesh.expert, mesh.seq) > 1:
        refuse(f"a data-parallel world of {world} / a multi-axis mesh "
               "(ZeRO-1/2 data parallelism)", "A.4")
    zc = config.zero_config
    if zc.stage >= 3:
        refuse(f"zero_optimization.stage {zc.stage} (ZeRO-3)", "A.5")
    for what, off in (("offload_param", zc.offload_param),
                      ("offload_optimizer", zc.offload_optimizer)):
        if off is not None and off.device not in (None, "none"):
            refuse(f"zero_optimization.{what} (the offload tier)", "A.7")
    if config.fp16.enabled:
        refuse("fp16.enabled (the kernels take bf16 and fp32; fp16 and its "
               "dynamic loss scaling)", "A.1b")
    if config.fused_step_config.enabled:
        refuse("fused_step (one dispatch per optimizer step)", "A.6")
    if (config.optimizer_name or "").lower() in (ONEBIT_ADAM_OPTIMIZER,
                                                 ONEBIT_LAMB_OPTIMIZER):
        refuse(f"the {config.optimizer_name} optimizer", "A.8")
    if zc.low_bandwidth.onebit:
        refuse("zero_optimization.low_bandwidth.onebit (the 1-bit wire "
               "tier)", "A.8")
    if zc.low_bandwidth.enabled:
        refuse("zero_optimization.low_bandwidth in the engine (the qwZ / qgZ "
               "ops and the fused collective-matmul are ported, "
               "runtime/comm/low_bandwidth.py and ops/collective_matmul.py; "
               "the engine uses them inside the streamed ZeRO-3 scan)", "A.5")
    if config.sequence_parallel_config.size > 1:
        refuse("sequence parallelism", "A.9")
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
            refuse(f"the {what} block", item)


class DeepSpeedEngine:
    """Config-driven training engine on one device."""

    def __init__(self, model=None, config=None, optimizer=None,
                 model_parameters=None, lr_scheduler=None,
                 training_data=None, collate_fn=None, device="cuda"):
        self.module = model
        self.device = torch.device(device)
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, world_size=1))
        self.world_size = 1
        refuse_unported(self.config, model)

        self.compute_dtype = (torch.bfloat16 if self.config.bf16.enabled
                              else torch.float32)
        self.scaler_cfg, self.scaler_state = create_loss_scaler(
            None, device=self.device)
        self._grads_half = (self.config.bf16.enabled
                            and self.config.bf16.grads_in_compute_dtype)

        # ---- fp32 master weights: one flat buffer, params are views ---- #
        if model_parameters is not None:
            model.load_state_dict(model_parameters)
        self._named_params = list(model.named_parameters())
        total = sum(p.numel() for _, p in self._named_params)
        self._flat = torch.empty(total, dtype=torch.float32,
                                 device=self.device)
        self._flat_grad = torch.zeros_like(self._flat)
        self._segments = []
        off = 0
        with torch.no_grad():
            for _, p in self._named_params:
                n = p.numel()
                view = self._flat[off:off + n].view(p.shape)
                view.copy_(p.detach())
                p.data = view
                p.requires_grad_(True)
                p.grad = self._flat_grad[off:off + n].view(p.shape)
                self._segments.append((off, n))
                off += n
        self._half_acc = None

        # ---- LR schedule + optimizer --------------------------------- #
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        if optimizer is not None:
            if not isinstance(optimizer, FlatOptimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch FlatOptimizer "
                    "(runtime.optimizers.build_optimizer), got "
                    f"{type(optimizer).__name__}")
            # the parameters' places in the flat buffer are the engine's
            optimizer.segments = self._segments
            self.optimizer = optimizer
        else:
            self.optimizer = build_optimizer(
                self.config.optimizer_name or "adam",
                self.config.optimizer_params,
                learning_rate=self.lr_scheduler,
                gradient_clipping=self.config.gradient_clipping,
                segments=self._segments)
        self.opt_state = self.optimizer.init(self._flat)

        self.training_dataloader = self._configure_dataloader(
            training_data, collate_fn)
        self._rng = torch.Generator(device=self.device).manual_seed(42)

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.world_size,
            steps_per_output=self.steps_per_print())
        self._last_loss = None
        self._last_overflow = None
        self._is_train_mode = True
        log_dist(f"DeepSpeedEngine: zero_stage="
                 f"{self.zero_optimization_stage()} dtype={self.compute_dtype} "
                 f"device={self.device} params={total} "
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

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "save_checkpoint is not ported yet (ROADMAP.md A.1b: the JAX "
            "layout of runtime/checkpoint.py)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "load_checkpoint is not ported yet (ROADMAP.md A.1b: the JAX "
            "layout of runtime/checkpoint.py)")

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
        if training_data is None:
            return None
        return DeepSpeedDataLoader(
            training_data, batch_size=self.train_micro_batch_size_per_gpu()
            * self.world_size, collate_fn=collate_fn)

    def _to_device(self, a):
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(self.device)
        return a

    # ------------------------------------------------------------------ #
    # forward / backward / step (reference: engine.py:1224,1303,1462)
    # ------------------------------------------------------------------ #
    def forward(self, *args, **kwargs):
        """The model's loss on the batch, on every parameter cast to the
        compute dtype; dropout draws from the engine's generator.  Returns
        the unscaled loss with its autograd graph."""
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).start()
        if self._is_train_mode:
            self.tput_timer.start()
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        cast = {name: p.to(self.compute_dtype) if p.is_floating_point() else p
                for name, p in self._named_params}
        loss = functional_call(self.module, cast, args,
                               dict(kwargs, generator=self._rng))
        self._last_loss = loss
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Backpropagate loss * loss_scale, accumulating the grads of the
        master weights across micro-steps."""
        loss = self._last_loss if loss is None else loss
        if loss is None:
            raise RuntimeError("backward() called before forward()")
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).start()
        (loss.float() * self.scaler_state.loss_scale).backward()
        if self._grads_half:
            half = self._flat_grad.to(self.compute_dtype)
            self._half_acc = (half if self._half_acc is None
                              else self._half_acc + half)
            self._flat_grad.zero_()
        self.micro_steps += 1
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).stop()
        return loss

    def step(self, lr_kwargs=None):
        """Apply the optimizer at gradient-accumulation boundaries; no host
        synchronisation."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).start()
        acc = self._half_acc if self._grads_half else self._flat_grad
        if acc is None:
            raise RuntimeError("step() called before backward()")
        inv = 1.0 / (self.scaler_state.loss_scale
                     * self.gradient_accumulation_steps())
        grads = acc.float() * inv
        finite = torch.isfinite(grads).all()
        self.optimizer.step(self._flat, grads, self.opt_state, finite)
        overflow = ~finite
        self.scaler_state = update_loss_scale(self.scaler_cfg,
                                              self.scaler_state, overflow)
        self._flat_grad.zero_()
        self._half_acc = None
        self._last_overflow = overflow
        self.global_steps += 1
        # the dynamic scaler (fp16) reads the flag to skip the scheduler,
        # as the JAX engine; bf16 / fp32 never do
        if self.scaler_cfg.dynamic and bool(overflow):
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step(**(lr_kwargs or {}))
        self.tput_timer.stop(global_step=True)
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).stop()

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
