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
gets that from its counter-based keys.)

`model_parallel_rng` forks a generator by the model-axis rank, the
counterpart of folding the axis index into the JAX key.
"""

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


def checkpoint_with_generator(function: Callable, generator, *args,
                              policy=None) -> Any:
    """`checkpoint` of `function(*args, generator=generator)` whose random
    draws all come from `generator`: the forward draws from it (leaving it
    where it would be without recompute), the recompute from a fresh
    generator set to the state it had before the forward, so each mask is
    drawn again as it was."""
    if generator is None:
        return checkpoint(functools.partial(function, generator=None), *args,
                          policy=policy)
    state = generator.get_state()
    runs = []

    def run(*inputs):
        if not runs:
            runs.append(generator)
            return function(*inputs, generator=generator)
        replay = torch.Generator(device=generator.device)
        replay.set_state(state)
        return function(*inputs, generator=replay)
    return _checkpoint(run, args, policy, False)


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
