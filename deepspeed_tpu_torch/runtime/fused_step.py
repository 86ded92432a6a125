"""The fused whole step: one optimizer step's window as one CUDA graph
(counterpart of deepspeed_tpu/runtime/fused_step.py).

The modular forward / backward / step protocol issues every kernel of a
window from the host: at gas = N, N forwards and N backwards with their
accumulation, then the step, a few thousand launches whose issue time can
exceed the device time (a rematted GPT-2 large step).  The JAX package
fuses the window into one jitted program; on the card its counterpart is a
CUDA graph, captured once and replayed for every step after:

    gas x (cast, forward, backward, accumulate)      # kernels A, B, D, E
    the sentinel's loss observe                      # optional, in-graph
    unscale -> finite flag -> the optimizer's select update
    the loss-scale transition                        # selects, in place

`FusedStep.window` is that body, the engine's own modular code: on the
CPU it runs eagerly, one call a step, and it is the plain version of the
graph.  On CUDA:

1. The first call runs the body eagerly: a real step, bitwise the modular
   one.  It creates what a capture cannot (NCCL communicators, the
   kernels' one-time attributes, the rank streams) and notes the
   recompute calls of a rematted model (activation_checkpointing's
   `RecomputeGenerators`).
2. The second call copies its batch into static device buffers (one
   [gas, rows, ...] buffer a leaf and local rank, filled from pinned host
   memory on the current stream), captures the body into one
   `torch.cuda.CUDAGraph` on a side stream (every rank stream forks from
   it and joins it again, `mesh.forked()`), and replays it.  A capture
   executes nothing, so the parameters, the optimizer state, the counters
   and the generators are as the capture found them.  Each rank's
   generator is registered with the graph, so each replay draws on from
   its current Philox offset, bitwise as the eager loop would; the
   recompute of a rematted layer draws from a generator of its own,
   registered too and set before each replay to the offset its layer's
   forward draws from.
3. Every later call copies its batch in and replays.

The graph's inputs are the tensors live at capture: the state the eager
step rebinds is written in place instead (the loss scaler's state, the
in-graph sentinel's EWMA); the optimizer's state already is.  The
kernels' wrappers count their launch calls, and the capture's calls are
recorded into the graph (`launches_captured` notes them); a replay
launches the graph's kernels without calling a wrapper, so no counter
moves then: a profiler trace of the replay counts them by kernel name.
A capture or a replay that fails raises: the step never carries on
eagerly on CUDA.

The host work of the JAX engine's `_fused_train_batch` stays in the
engine: the skip and scheduler chain, the sentinel's drain at boundaries,
the preemption check.  The step reads the device at most once after a
replay: fp16's overflow flag and the skip_step sentinel's verdict, both
in one read.  `fused_fallback_reason` keeps the JAX package's fallback
matrix: a config it names runs the modular loop.
"""

from typing import NamedTuple, Optional

import torch

from .. import ops
from .activation_checkpointing.checkpointing import RecomputeGenerators
from .dataloader import stack_microbatches

# matches the host sentinel's zscore floor (resilience/sentinel.py)
_VAR_FLOOR = 1e-12
# the packed result of a window: its mean loss, the overflow flag and the
# sentinel's verdicts (flagged, non-finite), one fp32 each
OUT_LOSS, OUT_OVERFLOW, OUT_FLAGGED, OUT_NONFINITE = range(4)


class FusedSentinelState(NamedTuple):
    """Device mirror of the host sentinel's loss EWMA (resilience/sentinel.py
    _EwmaStat), so that the loss-only verdict runs inside the window and
    gates the update through the same select as fp16's overflow skip.
    Counters, budget and abort stay on the host: the engine drains the
    verdicts at its logging boundaries."""
    mean: torch.Tensor      # fp32: EWMA mean of the window's mean loss
    var: torch.Tensor       # fp32: EWMA variance
    count: torch.Tensor     # int32: clean observations folded in


def sentinel_state_from_host(sentinel, device) -> FusedSentinelState:
    """The device EWMA seeded from the host sentinel (a new engine, or a
    checkpoint load after `load_state_dict`)."""
    state = FusedSentinelState(
        mean=torch.zeros((), dtype=torch.float32, device=device),
        var=torch.zeros((), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))
    load_sentinel_state(state, sentinel)
    return state


def load_sentinel_state(state: FusedSentinelState, sentinel) -> None:
    """Write the host sentinel's loss EWMA into `state` in place (a captured
    graph reads these tensors): fills, no host-to-device copy."""
    stat = sentinel.loss_stat
    state.mean.fill_(stat.mean if stat.mean is not None else 0.0)
    state.var.fill_(stat.var)
    state.count.fill_(stat.count)


def sentinel_state_to_host(state: FusedSentinelState, sentinel) -> None:
    """Fold the device EWMA back into the host sentinel (a checkpoint save:
    its state_dict must hold what the windows learned)."""
    count = int(state.count)
    sentinel.loss_stat.count = count
    sentinel.loss_stat.mean = float(state.mean) if count > 0 else None
    sentinel.loss_stat.var = float(state.var)


def fused_fallback_reason(engine) -> Optional[str]:
    """Why the fused path cannot serve this engine (None: it can).  The JAX
    package's fallback matrix with its strings: a feature that needs the
    host between the micro-steps, or between the grads and the update,
    takes the modular loop.  In the port only the sentinel's two cases can
    be reached; the engine refuses the others (`refuse_unported`)."""
    cfg = engine.config
    if getattr(engine, "_custom_grad_program", None) is not None:
        return ("a custom grad program (pipeline 1F1B executor) schedules "
                "its own step")
    off = cfg.zero_config.offload_optimizer
    if off is not None and off.device not in (None, "none"):
        return "offload_optimizer steps on the host (CPU/NVMe Adam)"
    if cfg.quantize_training_enabled:
        return "MoQ quantize-training runs host-scheduled post-step programs"
    if cfg.eigenvalue_config.enabled:
        return "eigenvalue curvature probes re-run the loss between steps"
    if cfg.pld_enabled:
        return "progressive_layer_drop injects per-step host state (theta)"
    if cfg.curriculum_enabled:
        return "curriculum_learning re-truncates the batch per step"
    if cfg.flops_profiler_config.enabled:
        return "flops_profiler arms the modular forward at profile_step"
    if engine.sentinel is not None:
        if engine.sentinel.policy == "rewind":
            return ("sentinel policy 'rewind' restores host checkpoints "
                    "mid-run")
        if engine.sentinel.monitor_grad_norm:
            return ("sentinel grad-norm monitoring reads accumulated grads "
                    "on the host (set resilience.sentinel.monitor_grad_norm "
                    "= false for in-program loss-only monitoring)")
    return None


def build_fused_step(engine) -> "FusedStep":
    """The fused step of `engine` (one host dispatch a window)."""
    engine._dispatches_per_step = 1
    return FusedStep(engine)


class FusedStep:
    """A window's whole step: `__call__(batches)` takes the window's gas
    micro-batches and returns the packed result ([4] fp32 on the engine's
    device: mean loss, overflow, flagged, non-finite), a tensor of its own.
    On the CPU each call runs `window` eagerly; on CUDA the first call runs
    it eagerly, the second captures it and replays, every later call
    replays (see the module's docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.gas = engine.gradient_accumulation_steps()
        sentinel = engine.sentinel
        self.sent_state = (sentinel_state_from_host(sentinel, engine.device)
                           if sentinel is not None else None)
        # (global step, packed result) awaiting the host sentinel's drain
        self.pending = []
        self.graphed = engine.mesh.is_cuda
        self.graph = None
        self.calls = 0
        self.replays = 0
        self.launches_captured = None
        self._recompute = RecomputeGenerators()
        self._static = None     # per local rank: a device buffer a leaf
        self._pinned = None     # per local rank: a pinned host buffer a leaf
        self._copied = None     # event after the last host-to-device copy
        self._out = None

    # -- the body --------------------------------------------------------- #
    def _observe(self, loss):
        """In-window mirror of TrainingSentinel.observe on the loss stream:
        non-finite always flags; a k-sigma spike flags after warmup (and
        never on the first observation: the device mean is a placeholder
        until then).  The baseline adapts on clean steps and, under the
        warn policy only, on finite spikes; a non-finite loss never moves
        it.  Returns (flagged, nonfinite) and updates the state in place."""
        s, st = self.engine.sentinel, self.sent_state
        alpha = float(s.loss_stat.alpha)
        nonfinite = ~torch.isfinite(loss)
        warmed = (st.count >= int(s.warmup_steps)) & (st.count > 0)
        z = torch.abs(loss - st.mean) / torch.sqrt(
            torch.clamp(st.var, min=_VAR_FLOOR))
        spike = warmed & (z > float(s.k_sigma)) & ~nonfinite
        flagged = nonfinite | spike
        adapt = ~flagged | spike if s.policy == "warn" else ~flagged
        first = st.count == 0
        diff = loss - st.mean
        incr = alpha * diff
        new_mean = torch.where(first, loss, st.mean + incr)
        new_var = torch.where(first, torch.zeros_like(st.var),
                              (1.0 - alpha) * (st.var + diff * incr))
        new_count = torch.where(adapt, st.count + 1, st.count)
        st.mean.copy_(torch.where(adapt, new_mean, st.mean))
        st.var.copy_(torch.where(adapt, new_var, st.var))
        st.count.copy_(new_count)
        return flagged, nonfinite

    def window(self, inputs):
        """The whole step of one window: `inputs` holds, a local rank, the
        tuple of the batch's leaves with the leading [gas] axis (this
        rank's rows, on its device or placed there).  The engine's own
        forward, backward and step code, with no host read: returns the
        packed result."""
        eng = self.engine
        losses = []
        for m in range(self.gas):
            loss = eng._forward_ranks(
                [(tuple(a[m] for a in args), {}) for args in inputs])
            eng._accumulate(loss)
            losses.append(loss.detach())
        mean_loss = torch.stack(losses).float().mean()
        flagged = nonfinite = torch.zeros((), dtype=torch.bool,
                                          device=mean_loss.device)
        healthy = None
        if self.sent_state is not None:
            flagged, nonfinite = self._observe(mean_loss)
            if eng.sentinel.policy == "skip_step":
                # rides the optimizer's finite select; the scaler sees only
                # the real overflow
                healthy = ~flagged
        overflow = eng._step_device(healthy)
        return torch.stack([mean_loss, overflow.float(), flagged.float(),
                            nonfinite.float()])

    # -- the batch -------------------------------------------------------- #
    def _shares(self, batches):
        """The window's batch stacked ([gas, rows, ...] leaves), cut into
        each local rank's rows: per leaf, one share a rank."""
        stacked = stack_microbatches(batches)
        return [self.engine._shard_stacked(leaf) for leaf in stacked]

    def _placed(self, shares):
        eng = self.engine
        return [tuple(eng._place(share[i], r) for share in shares)
                for i, r in enumerate(eng.local_ranks)]

    def _load_inputs(self, shares):
        """Copy the window's shares into the static buffers: each into its
        pinned host buffer (once the previous copy out of it is done),
        then to the device on the current stream."""
        if self._copied is not None:
            self._copied.synchronize()
        for i, (pinned, static) in enumerate(zip(self._pinned,
                                                 self._static)):
            for share, host, dev in zip(shares, pinned, static):
                host.copy_(torch.as_tensor(share[i]))
                dev.copy_(host, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()

    # -- the graph -------------------------------------------------------- #
    def _capture(self, shares):
        eng = self.engine
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "fused_step: this torch has no "
                "CUDAGraph.register_generator_state, which the dropout "
                "generators of a captured step need")
        self._pinned, self._static = [], []
        for i, r in enumerate(eng.local_ranks):
            host = [torch.as_tensor(share[i]) for share in shares]
            self._pinned.append([torch.empty(h.shape, dtype=h.dtype,
                                             pin_memory=True) for h in host])
            self._static.append([torch.empty(h.shape, dtype=h.dtype,
                                             device=eng.mesh.device_of(r))
                                 for h in host])
        self._load_inputs(shares)
        graph = torch.cuda.CUDAGraph()
        for gen in list(eng._rngs) + self._recompute.make_generators():
            graph.register_generator_state(gen)
        before = ops.launch_counts()
        with torch.cuda.graph(graph):
            with self._recompute.capture():
                out = self.window([tuple(s) for s in self._static])
        after = ops.launch_counts()
        self.launches_captured = {k: after[k] - before[k] for k in after}
        eng._last_loss = eng._rank_losses = None
        self.graph, self._out = graph, out

    def __call__(self, batches):
        shares = self._shares(batches)
        self.calls += 1
        if not self.graphed:
            return self.window(self._placed(shares))
        if self.calls == 1:
            # a real step, eager, noting the recompute calls for the capture
            with self._recompute.record(self.engine._rngs):
                return self.window(self._placed(shares))
        if self.graph is None:
            self._capture(shares)
        else:
            self._load_inputs(shares)
        self._recompute.prepare()
        self.graph.replay()
        self.replays += 1
        return self._out.clone()

    def static_bytes(self) -> int:
        """Bytes of the static input buffers on the device."""
        return sum(t.numel() * t.element_size()
                   for bufs in (self._static or ()) for t in bufs)
