"""Activation checkpointing (counterpart of
deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py).

The configured knobs become `torch.utils.checkpoint` calls, always
non-reentrant, where the JAX package picks `jax.checkpoint` policies:

- nothing configured: recompute everything (`nothing_saveable`);
- `partition_activations`: save the matmul outputs (`aten.mm`, `addmm`,
  `bmm`), recompute the rest (`dots_saveable`), through PyTorch's
  selective checkpointing;
- `cpu_checkpointing`: save the outputs of the products without batch
  dims (`aten.mm`, `addmm`) in pinned host memory, recompute the rest
  (`offload_dot_with_no_batch_dims("device", "pinned_host")`): the
  forward copies each one off the device as it is made, and the recompute
  takes it back in place of the product;
- `contiguous_memory_optimization`: accepted and logged, as in the JAX
  package (the caching allocator packs the buffers).

`checkpoint_with_generator` is the form a layer that drops out needs.
`torch.utils.checkpoint`'s `preserve_rng_state` restores only the default
generators, and the port's dropout draws from an explicit one (kernel B's
Philox seed and the hidden masks, ops/transformer.py), so a plain wrap
would recompute the layer with fresh masks and return wrong gradients
without an error.  The wrapper takes the generator's state before the
forward, runs the forward on the caller's generator (which ends where it
would without recompute), and recomputes on a fresh generator set to the
saved state: every mask is drawn again as it was, and the loss and the
gradients equal those without recompute, bit for bit.  (The JAX package
gets that from its counter-based keys.)  Inside a CUDA graph capture of a
window (runtime/fused_step.py) the state cannot be read on the host:
`RecomputeGenerators` gives each recompute a generator of its own that
the graph reads at each replay.

`model_parallel_rng` forks a generator by the model-axis rank, the
counterpart of folding the axis index into the JAX key.
"""

import contextlib
import functools
import hashlib
from typing import Any, Callable, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from ...parallel.mesh import MODEL_AXIS, get_mesh_context
from ...utils.logging import log_dist

_CONFIG = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "configured": False,
}

# the products a `dots_saveable` policy keeps (jax.lax.dot_general's
# counterparts on the ATen level), and those of them without batch dims
UNBATCHED_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
DOT_OPS = UNBATCHED_DOT_OPS + (torch.ops.aten.bmm.default,)


def configure(mpu_=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """The knobs from explicit flags or a config's activation_checkpointing
    section (a DeepSpeedConfig, a dict holding the section, or the section's
    dataclass); explicit flags win."""
    cfg = None
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing_config",
                      None) or (deepspeed_config.get(
                          "activation_checkpointing")
                          if isinstance(deepspeed_config, dict) else None)
    if cfg is not None and not isinstance(cfg, dict):
        import dataclasses
        if dataclasses.is_dataclass(cfg):
            cfg = dataclasses.asdict(cfg)
        else:
            cfg = {k: getattr(cfg, k) for k in dir(cfg)
                   if not k.startswith("_") and not callable(
                       getattr(cfg, k))}
    if isinstance(cfg, dict):
        _CONFIG["partition_activations"] = bool(
            cfg.get("partition_activations", False))
        _CONFIG["contiguous_memory_optimization"] = bool(
            cfg.get("contiguous_memory_optimization", False))
        _CONFIG["cpu_checkpointing"] = bool(
            cfg.get("cpu_checkpointing", False))
        _CONFIG["number_checkpoints"] = cfg.get("number_checkpoints")
        _CONFIG["profile"] = bool(cfg.get("profile", False))
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization",
                      contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile)):
        if val is not None:
            _CONFIG[key] = val
    if _CONFIG["contiguous_memory_optimization"]:
        log_dist("activation checkpointing: contiguous_memory_optimization "
                 "is implicit under the caching allocator", ranks=[0])
    _CONFIG["configured"] = True


def is_configured() -> bool:
    return _CONFIG["configured"]


def reset() -> None:
    for k in _CONFIG:
        _CONFIG[k] = False if isinstance(_CONFIG[k], bool) else None
    _CONFIG["configured"] = False


def nothing_saveable(ctx, op, *args, **kwargs):
    """Recompute every op (a plain checkpoint)."""
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def dots_saveable(ctx, op, *args, **kwargs):
    """Save the matmul outputs, recompute the rest."""
    if op in DOT_OPS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def offload_dots_to_pinned_host(ctx, op, *args, **kwargs):
    """Save the outputs of the products without batch dims in pinned host
    memory, recompute the rest (`checkpoint` gives this policy its own pair
    of contexts, which act on UNBATCHED_DOT_OPS)."""
    if op in UNBATCHED_DOT_OPS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def get_partition_policy():
    """The selective-checkpoint policy the configured knobs imply."""
    if _CONFIG["cpu_checkpointing"]:
        return offload_dots_to_pinned_host
    if _CONFIG["partition_activations"]:
        return dots_saveable
    return nothing_saveable


class _OffloadDots(TorchDispatchMode):
    """The forward under `cpu_checkpointing`: the output of every product
    without batch dims is also copied into pinned host memory (when it lies
    on a card), in the order the products run."""

    def __init__(self, store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in UNBATCHED_DOT_OPS:
            host = out.detach()
            if host.is_cuda:
                host = torch.empty(host.shape, dtype=host.dtype,
                                   pin_memory=True).copy_(host,
                                                          non_blocking=True)
            else:
                host = host.clone()
            self.store.append(host)
        return out


class _ReloadDots(TorchDispatchMode):
    """The recompute under `cpu_checkpointing`: each product without batch
    dims takes its saved output back from the host instead of running."""

    def __init__(self, store):
        super().__init__()
        self.store = store
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in UNBATCHED_DOT_OPS:
            saved = self.store[self.next]
            self.next += 1
            return saved.to(args[0].device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store = []
    return _OffloadDots(store), _ReloadDots(store)


def context_fn(policy) -> Callable:
    """torch.utils.checkpoint's `context_fn` for a policy above."""
    if policy is nothing_saveable:
        return torch_checkpoint.noop_context_fn
    if policy is offload_dots_to_pinned_host:
        return _offload_contexts
    return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                             policy)


def _checkpoint(function, args, policy, preserve_rng_state):
    policy = get_partition_policy() if policy is None else policy
    return torch_checkpoint.checkpoint(
        function, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state, context_fn=context_fn(policy))


def checkpoint(function: Callable, *args, policy=None) -> Any:
    """Run `function(*args)` now and recompute it in the backward under
    `policy` (default: the configured one), non-reentrant.  The default
    generators' states are restored for the recompute, as
    torch.utils.checkpoint does; a function that draws from a generator of
    its own takes `checkpoint_with_generator`."""
    return _checkpoint(function, args, policy, True)


class RecomputeGenerators:
    """The generators the recomputes of one CUDA-graphed window draw from
    (runtime/fused_step.py).

    Outside a capture `checkpoint_with_generator` reads the generator's
    state (`get_state`, a host copy of its seed and Philox offset) before
    the forward and recomputes on a fresh generator set to it.  Inside a
    capture torch refuses to make a generator or to set another seed on
    one, and a host copy would replay the capture's masks on every
    replay; the graph-safe forms do not serve either (graph_rng_probe.py:
    an in-capture `clone_state` is refused, a `graphsafe_get_state`
    shares the live state, and a registered clone matches the first
    replay only unless it is set again before each).  So the window is
    first run eagerly under `record()`: each call's generator and the
    Philox offset it had reached since the window began are noted, in
    call order.  The capture then runs under `capture()`: the i-th call
    recomputes on the i-th of `generators`, new generators the caller
    registers with the graph (`CUDAGraph.register_generator_state`), so
    that the graph reads their seed and offset at each replay.
    `prepare()` sets each to its call's generator's seed and offset
    before a replay, plus the call's offset into the window: the
    recompute draws each mask again as the forward drew it in that
    replay."""

    def __init__(self):
        self.calls = []          # (generator, Philox offset into the window)
        self.generators = []     # one a call, made for the capture
        self._start = {}
        self._mode = None
        self._next = 0

    @staticmethod
    def _seed_offset(generator):
        state = generator.get_state()
        return (int(state[:8].view(torch.int64)),
                int(state[8:16].view(torch.int64)))

    @contextlib.contextmanager
    def _active(self, mode):
        global _RECOMPUTE
        if _RECOMPUTE is not None:
            raise RuntimeError("a window's recompute generators are in use")
        self._mode, self._next, _RECOMPUTE = mode, 0, self
        try:
            yield self
        finally:
            _RECOMPUTE, self._mode = None, None

    def record(self, generators):
        """Run the window eagerly and note its calls; `generators` are the
        ones its draws come from, read here at the window's start."""
        self.calls = []
        self._start = {id(g): self._seed_offset(g)[1] for g in generators}
        return self._active("record")

    def capture(self):
        """Capture the window: the calls take the `generators` in order."""
        if len(self.generators) != len(self.calls):
            raise RuntimeError(
                f"{len(self.generators)} recompute generators for "
                f"{len(self.calls)} recorded calls")
        return self._active("capture")

    def make_generators(self):
        """One new generator a recorded call, on its generator's device."""
        self.generators = [torch.Generator(device=g.device)
                           for g, _ in self.calls]
        return self.generators

    def prepare(self):
        """Before a replay: each call's generator at its seed and its
        offset into the window, from the host state of the generator the
        forward draws from (the replay's starting point)."""
        for (g, into), replay in zip(self.calls, self.generators):
            seed, offset = self._seed_offset(g)
            state = torch.tensor([seed, offset + into], dtype=torch.int64)
            replay.set_state(state.view(torch.uint8))

    def _note(self, generator):
        """The generator a recompute of this call draws from, or None to
        take the state eagerly (record, or no window)."""
        if self._mode == "record":
            start = self._start.get(id(generator))
            if start is None:
                raise RuntimeError("a checkpointed call drew from a "
                                   "generator the window did not name")
            self.calls.append(
                (generator, self._seed_offset(generator)[1] - start))
            return None
        i, self._next = self._next, self._next + 1
        if i >= len(self.generators) or self.calls[i][0] is not generator:
            raise RuntimeError(
                f"checkpointed call {i} of the captured window differs "
                "from the recorded window's")
        return self.generators[i]


_RECOMPUTE: Optional[RecomputeGenerators] = None


def checkpoint_with_generator(function: Callable, generator, *args,
                              policy=None) -> Any:
    """`checkpoint` of `function(*args, generator=generator)` whose random
    draws all come from `generator`: the forward draws from it (leaving it
    where it would be without recompute), the recompute from a fresh
    generator set to the state it had before the forward, so each mask is
    drawn again as it was.  While a CUDA graph of the window is captured
    the recompute draws from the generator `RecomputeGenerators` made for
    this call instead."""
    if generator is None:
        return checkpoint(functools.partial(function, generator=None), *args,
                          policy=policy)
    replay = recompute_generator(generator)
    runs = []

    def run(*inputs):
        if not runs:
            runs.append(generator)
            return function(*inputs, generator=generator)
        return function(*inputs, generator=replay())
    return _checkpoint(run, args, policy, False)


def recompute_generator(generator) -> Callable[[], Any]:
    """Called before a forward that draws from `generator` and is
    recomputed later: returns a function that gives the generator the
    recompute draws from, one at the state `generator` has now (a fresh
    generator set to it; inside a window's capture the one
    `RecomputeGenerators` made for this call).  None stays None."""
    if generator is None:
        return lambda: None
    graphed = _RECOMPUTE._note(generator) if _RECOMPUTE is not None else None
    if graphed is not None:
        return lambda: graphed
    state = generator.get_state()

    def replay():
        fresh = torch.Generator(device=generator.device)
        fresh.set_state(state)
        return fresh
    return replay


class CheckpointFunction:
    """API-parity shim (reference: checkpointing.py:482)."""

    @staticmethod
    def apply(function, *args):
        return checkpoint(function, *args)


def model_parallel_rng(generator, rank: int = 0, axis_name: str = MODEL_AXIS,
                       mesh=None):
    """The generator a model-parallel rank draws its dropout from: at a
    model axis of 1 (every mesh the engine runs; A.9 refuses more) the
    generator itself; above, a new generator on its device seeded from the
    generator's state and the rank's coordinate on the axis, as the JAX
    package folds the axis index into the key."""
    mesh = mesh if mesh is not None else get_mesh_context(required=False)
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return generator
    index = mesh.axis_index(rank, axis_name)
    digest = hashlib.blake2b(
        generator.get_state().numpy().tobytes() + index.to_bytes(4, "little"),
        digest_size=8).digest()
    return torch.Generator(device=generator.device).manual_seed(
        int.from_bytes(digest, "little") >> 1)
